"""The port's data and utility modules against ``rgie_tpu`` on the CPU:
``data/augmentor.py`` and ``dataset.augment_image``, ``data/stores.py``,
``data/prefetch.py``, ``data/native_preprocess.py`` (and
``cli/bench_preprocess.py``), ``losses/compound.py``,
``utils/yaml_config.py``, ``utils/misc.py``,
``utils/bench_history.py``, and ``utils/checkpoint.py``'s
``save_checkpoint``/``load_checkpoint`` and ``EditManifest``; also the
profile flags of ``cli/bench.py`` (``--steps``, ``--top``, ``--logdir``,
``--parse-only``).

Tolerances: the numpy and PIL copies (augmentor, stores, native binding,
splits, configs) equal their originals; the native C++ path against the PIL
path 0.02, the JAX package's own bound; the compound vector on float32
tensors against JAX's 1e-6 absolute (angles in [0, 2 pi)).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

AUG_LIST = {"resize_smallest_side": 40, "random_resize_h_w_aspect": "36,40(0.8,1.25)",
            "rotate": 10, "random_rotate_90": True, "random_scale_limit": 0.2,
            "random_crop_h_w": "32,30", "center_crop_h_w": "28,28", "horizontal_flip": True,
            "contrast": {"p": 1.0}, "blur": {"p": 1.0, "blur_limit": 5},
            "motion_blur": {"p": 1.0, "blur_limit": 5}, "compression": {"p": 1.0},
            "gamma": {"p": 1.0}, "max_time_step": 3}


def test_augmentor_and_augment_image_equal_jax(rng):
    from rgie_tpu.data.augmentor import Augmentor as Augmentor_j
    from rgie_tpu.data.dataset import augment_image as augment_j
    from rgie_tpu_torch.data.augmentor import Augmentor
    from rgie_tpu_torch.data.dataset import augment_image

    image = rng.uniform(0, 1, (48, 56, 3)).astype(np.float32)
    for seed in range(3):
        got = Augmentor(AUG_LIST)(image, np.random.default_rng(seed))
        expect = Augmentor_j(AUG_LIST)(image, np.random.default_rng(seed))
        assert got.dtype == np.float32 and np.array_equal(got, expect)
        kw = dict(resize_hw=(40, 44), random_crop_hw=(32, 30), horizontal_flip=True)
        assert np.array_equal(augment_image(image, np.random.default_rng(seed), **kw),
                              augment_j(image, np.random.default_rng(seed), **kw))
    with pytest.raises(ValueError, match="Unknown augmentation"):
        Augmentor({"sharpen": 1})(image, np.random.default_rng(0))


@pytest.fixture()
def folder_root(tmp_path):
    from PIL import Image

    (tmp_path / "images" / "seg").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ("images/a.png", "images/seg/b.jpg"):
        Image.fromarray(rng.integers(0, 255, (8, 10, 3), dtype=np.uint8)).save(tmp_path / name)
    (tmp_path / "images" / "meta.txt").write_bytes(b"hello")
    return tmp_path / "images"


def test_folder_store_equals_jax(folder_root):
    from rgie_tpu.data.stores import FolderStore as FolderStore_j
    from rgie_tpu_torch.data.stores import FolderStore, load_from_folder

    store, store_j = FolderStore(str(folder_root)), FolderStore_j(str(folder_root))
    assert store.keys() == store_j.keys() == ["a.png", "meta.txt", "seg/b.jpg"]
    for key, kind in ((b"a.png", "images"), ("seg/b.jpg", "images")):
        assert np.array_equal(store.getitem_by_path(key, kind), store_j.getitem_by_path(key, kind))
    out = load_from_folder({"images": ["a.png", "seg/b.jpg"], "meta": "meta.txt"},
                           {"images": store, "meta": store})
    assert [i.shape for i in out["images"]] == [(8, 10, 3), (8, 10, 3)]
    assert out["meta"] == [b"hello"]
    with pytest.raises(FileNotFoundError):
        FolderStore(str(folder_root / "nope"))


def test_lmdb_store_needs_lmdb(tmp_path):
    """Without the optional ``lmdb`` module the store fails when it is made
    (the import is lazy: the module itself imports without it)."""
    from rgie_tpu_torch.data.stores import LmdbStore

    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="lmdb"):
            LmdbStore(str(tmp_path))
        return
    pytest.skip("lmdb is installed: test_lmdb_store_round_trip covers it")


def test_lmdb_store_round_trip(tmp_path, folder_root):
    lmdb = pytest.importorskip("lmdb")
    from rgie_tpu_torch.data.stores import LmdbStore, load_from_lmdb

    env = lmdb.open(str(tmp_path / "db"))
    with env.begin(write=True) as txn:
        txn.put(b"a.png", (folder_root / "a.png").read_bytes())
    env.close()
    out = load_from_lmdb({"images": "a.png"}, {"images": LmdbStore(str(tmp_path / "db"))})
    assert out["images"][0].shape == (8, 10, 3)


def _images(rng):
    return [rng.integers(0, 256, (100, 140, 3), dtype=np.uint8),
            rng.integers(0, 256, (70, 60, 3), dtype=np.uint8)]


def test_native_binding_equals_jax_and_pil(rng):
    from rgie_tpu.data.native_preprocess import preprocess_batch as preprocess_j
    from rgie_tpu_torch.data.dataset import preprocess_image
    from rgie_tpu_torch.data.native_preprocess import native_available, preprocess_batch

    imgs = _images(rng)
    out = preprocess_batch(imgs, 64, 56)
    assert out.shape == (2, 56, 56, 3) and out.dtype == np.float32
    assert np.array_equal(out, preprocess_j(imgs, 64, 56))
    assert np.array_equal(preprocess_batch(imgs, 64, 56, normalize=True),
                          preprocess_j(imgs, 64, 56, normalize=True))
    ref = np.concatenate([preprocess_image(i.astype(np.float32) / 255, 64, 56) for i in imgs])
    assert np.abs(out - ref).max() < (0.02 if native_available() else 1e-6)


def test_bench_preprocess_prints_its_path(tmp_path, monkeypatch, capsys):
    from rgie_tpu_torch.cli import bench_preprocess
    from rgie_tpu_torch.data.native_preprocess import native_available
    from rgie_tpu_torch.utils import bench_history

    monkeypatch.setattr(bench_history, "HISTORY_PATH", tmp_path / "history.jsonl")
    row = bench_preprocess.main(["--n", "4", "--hw", "48", "--resize", "40", "--crop", "32",
                                 "--runs", "1"])
    path = "native" if native_available() else "pil"
    assert f"preprocess_batch ran the {path} path" in capsys.readouterr().out
    assert row["detail"]["path"] == path and row["value"] > 0
    (entry,) = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    assert entry["bench"] == "cli.bench_preprocess" and entry["value"] == row["value"]


class _Dataset:
    def __init__(self, rng, n=5):
        self.images = [rng.uniform(0, 1, (20, 30, 3)).astype(np.float32) for _ in range(n)]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], (f"n{i}", f"p{i}", "c")


@pytest.mark.parametrize("use_native", [False, True])
def test_prefetch_batches_order_and_device(rng, use_native):
    """The batches of ``iterate_batches``, in order, as tensors on the device
    asked for (the CPU here: the pinned copy needs a card)."""
    from rgie_tpu_torch.data.dataset import iterate_batches
    from rgie_tpu_torch.data.prefetch import prefetch_batches

    ds = _Dataset(rng)
    got = list(prefetch_batches(ds, 2, 16, 12, limit=5, device=torch.device("cpu"),
                                use_native=use_native))
    expect = list(iterate_batches(ds, 2, 16, 12, limit=5))
    assert [m for _, m in got] == [m for _, m in expect]
    for (images, _), (expect_images, _) in zip(got, expect):
        assert isinstance(images, torch.Tensor) and images.device.type == "cpu"
        np.testing.assert_allclose(images.numpy(), expect_images, atol=0.02 if use_native else 0)
    assert [b.shape[0] for b, _ in got] == [2, 2, 1]


def test_prefetch_iterator_raises_the_producers_error():
    from rgie_tpu_torch.data.prefetch import PrefetchIterator

    items = [(np.full((2, 4, 4, 3), i, np.float32), [f"m{i}"]) for i in range(5)]
    out = list(PrefetchIterator(iter(items), depth=2))
    assert [m for _, m in out] == [m for _, m in items] and out[3][0][0, 0, 0, 0] == 3

    def bad():
        yield items[0]
        raise ValueError("boom")

    it = PrefetchIterator(bad(), depth=1)
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("width", [8, 3])
def test_compound_emotion_matches_jax(rng, width):
    from rgie_tpu.losses import compound as CJ
    from rgie_tpu_torch.losses import compound as C

    emotions = rng.dirichlet(np.ones(8), 16).astype(np.float32) if width == 8 else \
        rng.uniform(0, 2, (16, 3)).astype(np.float32)
    got = C.from_vector_or_distribution(torch.from_numpy(emotions))
    expect = CJ.from_vector_or_distribution(jnp.asarray(emotions))
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-6)
    if width == 8:
        assert set(got.polarity.tolist()) == {0.0, 1.0}


def test_yaml_config_equals_jax(tmp_path):
    from rgie_tpu.utils import yaml_config as YJ
    from rgie_tpu_torch.utils import yaml_config as Y

    p = tmp_path / "cfg.yaml"
    p.write_text("gen:\n  latent_dim: 8\n  num_filters: 32\n  num_res_blocks: 2\n"
                 "  style_norm_type: none\n  weight_norm_type: spectral\n  pre_act: True\n"
                 "dis:\n  num_filters: 24\n  num_layers: 4\nextra:\n  deep: {x: 1}\n")
    for convert in ("munit_gen_config_from_yaml", "munit_dis_config_from_yaml"):
        got, expect = getattr(Y, convert)(str(p)), getattr(YJ, convert)(str(p))
        assert vars(got) == vars(expect)
    cfg = Y.load_yaml(str(p))
    assert cfg.extra.deep.x == 1 and cfg == YJ.load_yaml(str(p))
    base = {"a": {"b": 1, "c": 2}}
    assert Y.recursive_update(base, {"a": {"b": 5}, "d": 3}) == {"a": {"b": 5, "c": 2}, "d": 3}


def test_metrics_logger_and_misc_equal_jax(tmp_path, rng):
    from rgie_tpu.utils import misc as MJ
    from rgie_tpu_torch.utils import misc as M

    a, b = rng.standard_normal((3, 2)), rng.standard_normal((3, 2))
    assert np.array_equal(M.interweave_batch_tensors(a, b), MJ.interweave_batch_tensors(a, b))
    for got, expect in zip(M.create_dataset_splits(10, 0.3, seed=1),
                           MJ.create_dataset_splits(10, 0.3, seed=1)):
        assert np.array_equal(got, expect)
    assert M.perform_val_train_split(list("abcde")) == MJ.perform_val_train_split(list("abcde"))
    assert M.get_device_info() == "cpu x1"
    out = M.plot_imgs_tensor(rng.uniform(0, 1, (2, 8, 8, 3)), titles="t",
                             save_path=str(tmp_path / "grid.png"))
    assert out == str(tmp_path / "grid.png") and os.path.getsize(out) > 0


def test_bench_history_appends_to_the_path_given(tmp_path, monkeypatch):
    from rgie_tpu_torch.utils import bench_history

    monkeypatch.setenv("RGIE_FLASH_ATTN", "0")
    path = tmp_path / "sub" / "history.jsonl"
    bench_history.record("cli.bench", {"metric": "m", "value": 1.5, "detail": {"batch": 2}},
                         path=str(path))
    bench_history.record("cli.bench_gan", {"metric": "n", "value": 2.0}, path=str(path))
    first, second = [json.loads(line) for line in open(path)]
    assert first["bench"] == "cli.bench" and first["value"] == 1.5
    assert first["detail"] == {"batch": 2, "rgie_env": {"RGIE_FLASH_ATTN": "0"}}
    assert second["bench"] == "cli.bench_gan" and "ts" in second and "git_sha" in second
    assert bench_history.HISTORY_PATH.name == "bench_history_torch.jsonl"
    bench_history.record("x", {"value": 1}, path="/proc/no/such/dir/h.jsonl")   # never raises


def test_checkpoint_round_trip_and_edit_manifest_read_by_jax(tmp_path):
    from rgie_tpu.utils.checkpoint import EditManifest as EditManifest_j
    from rgie_tpu_torch.utils.checkpoint import EditManifest, load_checkpoint, save_checkpoint

    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    tree = {"model": model.state_dict(), "optimizer": opt.state_dict(), "epoch": 4}
    path = save_checkpoint(str(tmp_path / "ckpt"), tree, step=7)
    assert path.endswith("step_7")
    back = load_checkpoint(path)
    assert back["epoch"] == 4 and torch.equal(back["model"]["weight"], model.weight)
    assert torch.equal(back["optimizer"]["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    plain = save_checkpoint(str(tmp_path / "plain"), model.state_dict())
    loaded = load_checkpoint(plain, torch.nn.Linear(3, 2))
    assert torch.equal(loaded.weight, model.weight) and torch.equal(loaded.bias, model.bias)

    manifest = EditManifest(str(tmp_path / "runs" / "manifest.jsonl"))
    assert not manifest.is_done("img1", "pos_01")
    manifest.mark("img1", "pos_01", rec_error=0.1)
    manifest.close()
    with open(tmp_path / "runs" / "manifest.jsonl", "a") as f:
        f.write('{"key": "img2::neg_01"')                 # a line cut short by a stop
    jax_side = EditManifest_j(str(tmp_path / "runs" / "manifest.jsonl"))
    assert jax_side.done == {"img1::pos_01"}
    assert EditManifest(str(tmp_path / "runs" / "manifest.jsonl")).done == jax_side.done
    jax_side.close()


def _trace(path):
    events = [{"ph": "X", "cat": "kernel", "name": "gemm", "dur": 300.0},
              {"ph": "X", "cat": "kernel", "name": "gemm", "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "softmax", "dur": 100.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 900.0}]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("module", ["bench", "bench_gan"])
def test_bench_parse_only_reads_the_trace(tmp_path, capsys, module):
    """``--parse-only`` tabulates the device kernels of the trace in
    ``--logdir`` (host operators left out) and runs nothing."""
    import importlib

    cli = importlib.import_module(f"rgie_tpu_torch.cli.{module}")
    _trace(tmp_path)
    cli.main(["--parse-only", "--logdir", str(tmp_path), "--top", "1", "--device", "no-such"])
    out = capsys.readouterr().out
    assert "2 kernels, device time 0.5 ms" in out
    assert "80.0%" in out and "x2" in out and "gemm" in out and "softmax" not in out
    with pytest.raises(SystemExit, match="--logdir"):
        cli.main(["--parse-only"])


def test_bench_profile_flags_reach_the_profiler(monkeypatch):
    """``--steps 3 --top 5 --logdir D``: three objective steps in the window,
    and the profiler told the rows to print and where to write the trace."""
    from rgie_tpu_torch.cli import bench, profile_adapt_images

    calls, profiled = [], []
    monkeypatch.setattr(bench, "build", lambda *a: (None, None, None, None))
    monkeypatch.setattr(bench, "objective_step", lambda *a: lambda: calls.append(1))

    def profile_phase(what, step, **kw):
        step()
        profiled.append((what, kw))
    monkeypatch.setattr(profile_adapt_images, "profile_phase", profile_phase)
    bench.main(["--profile", "--steps", "3", "--top", "5", "--logdir", "trace_dir",
                "--device", "cpu", "--batch", "2"])
    assert len(calls) == 3
    assert profiled == [("3 x parametric objective step (256 px, batch 2, bfloat16)",
                         {"top": 5, "logdir": "trace_dir"})]
