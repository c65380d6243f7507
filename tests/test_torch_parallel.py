"""Slice F of the port against ``rgie_tpu`` on the CPU: data parallelism over
processes (``rgie_tpu_torch/parallel``, ``ShardedView``, the four CLIs and
the DDP midu step).

Unit checks: a single process is a no-op, the JAX package's ``RGIE_*``
launch variables map onto torch's, ``ShardedView`` and ``pad_to_multiple``
equal JAX's, a model axis divides the processes of a host (the model axis
itself: ``tests/test_torch_model_axis.py``), NCCL refuses two ranks on a
card.

Then one module-scoped run of two ``gloo`` processes on the CPU (the
counterpart of ``__graft_entry__.dryrun_multichip``), each running, in one
group: the DDP midu step on its half of fixed features (rank 1 starting
from other weights, which the broadcast replaces); the parametric, GAN,
diffusion (``--scale tiny``) and training CLIs on 3-image feeds at a global
batch of 2 (4 for training). The same CLIs then run in this process alone.

Tolerances: the DDP step against JAX's ``shard_train_step`` on the 8-device
CPU mesh as ``tests/test_torch_train_midu.py`` holds one step (``STEP_RTOL``
relative; parameters also 1e-2 of an Adam step absolute), the mean loss
1e-6 relative; the ranks' midus bit-identical. A rank's rows against the
one-process rows of the same images (a batch of 1 against a batch of 2:
other summation orders in the convolutions): the parametric edit 1e-5
relative + 1e-5 absolute on images in [0, 1] (``tests/test_torch_gan_edit.py``'s
rows against single edits); the GAN edit 1e-4 absolute on images in
[-1, 1] (readings up to 1.5e-5: the decoder's instance norms carry the
style codes' rounding into the image); the diffusion edit
1e-4 of the largest entry (``tests/test_torch_batched_edit.py``'s rows
against single edits).
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from rgie_tpu_torch import parallel as PAR
from rgie_tpu_torch.data import ShardedView
from rgie_tpu_torch.parallel import distributed as D

torch.set_num_threads(2)

STEP_RTOL = 1e-4
# The DDP step's midu (the tiny UNet's mid width) and its learning rate and
# decay: large enough for one step to move every weight and the L2 term to
# count.
MIDU_IN, MIDU_LR, MIDU_WD = 16, 1e-3, 0.5
VA_SIZE, VA_CROP = 64, 56
LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "RGIE_COORDINATOR", "RGIE_NUM_PROCESSES", "RGIE_PROCESS_ID")


@pytest.fixture
def no_launch(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# Unit checks
# ---------------------------------------------------------------------------


def test_single_process_is_a_no_op(no_launch):
    assert not PAR.init_distributed()
    assert PAR.process_info() == (0, 1) and PAR.is_main_process()
    PAR.all_processes_barrier()
    assert PAR.create_mesh() == PAR.create_hybrid_mesh() == PAR.Mesh(1, 1)
    assert PAR.create_mesh().shape == {PAR.DATA_AXIS: 1, PAR.MODEL_AXIS: 1}
    assert PAR.split_batch(3) == 3
    x = torch.arange(3.0)
    assert PAR.all_mean(x) is x and torch.equal(x, torch.arange(3.0))
    assert PAR.process_device("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_rgie_variables_map_to_the_torch_launch(no_launch):
    """The JAX package's contract (coordinator host:port, world size, rank)
    gives the same launch as torchrun's variables; torchrun's win where both
    are set; a world without a coordinator raises before any wait."""
    no_launch.setenv("RGIE_COORDINATOR", "10.0.0.1:8476")
    no_launch.setenv("RGIE_NUM_PROCESSES", "3")
    no_launch.setenv("RGIE_PROCESS_ID", "2")
    assert D.launch_env() == D.LaunchEnv(2, 3, 2, "10.0.0.1:8476")
    assert PAR.process_info() == (2, 3) and not PAR.is_main_process()
    no_launch.setenv("LOCAL_RANK", "0")
    assert D.launch_env().local_rank == 0
    with pytest.raises(SystemExit, match="--batch 4 must divide over 3 processes"):
        PAR.split_batch(4)
    for var, value in (("WORLD_SIZE", "2"), ("RANK", "1"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", "29500")):
        no_launch.setenv(var, value)
    assert D.launch_env() == D.LaunchEnv(1, 2, 0, "localhost:29500")
    no_launch.delenv("MASTER_ADDR")
    no_launch.delenv("RGIE_COORDINATOR")
    with pytest.raises(RuntimeError, match="names no coordinator"):
        PAR.init_distributed(device_type="cpu")


@pytest.mark.parametrize("nproc", [2, 3])
def test_sharded_view_matches_jax(nproc):
    """N = 5 items: the same length on every rank, the same items (the
    trailing rank clamped to the last), and ``local_count`` the rank's own."""
    from rgie_tpu.data.dataset import ShardedView as ShardedView_j

    items = [f"item{i}" for i in range(5)]
    owned = []
    for pid in range(nproc):
        view, view_j = ShardedView(items, pid, nproc), ShardedView_j(items, pid, nproc)
        assert len(view) == len(view_j) == -(-5 // nproc)
        assert [view[i] for i in range(len(view))] == [view_j[i] for i in range(len(view_j))]
        owned += [view[i] for i in range(view.local_count())]
        assert view.local_count(2) == len(range(pid, 2, nproc))
        with pytest.raises(IndexError):
            view[len(view)]
    assert sorted(owned) == items
    with pytest.raises(ValueError, match="out of range"):
        ShardedView(items, nproc, nproc)


def test_pad_to_multiple_matches_jax():
    from rgie_tpu.parallel.mesh import pad_to_multiple as pad_j

    batch = np.random.default_rng(0).standard_normal((5, 3, 2)).astype(np.float32)
    for multiple in (1, 2, 4, 5, 8):
        got, n = PAR.pad_to_multiple(batch, multiple)
        expect, n_j = pad_j(batch, multiple)
        assert n == n_j == 5 and np.array_equal(got, expect)


def test_a_model_axis_divides_the_processes_of_a_host(no_launch):
    no_launch.setenv("WORLD_SIZE", "4")
    assert PAR.create_mesh() == PAR.Mesh(4, 1)
    assert PAR.create_mesh((2, 2)) == PAR.create_hybrid_mesh(model_parallel=2) == PAR.Mesh(2, 2)
    assert PAR.create_mesh((1, 4)).shape == {PAR.DATA_AXIS: 1, PAR.MODEL_AXIS: 4}
    with pytest.raises(ValueError, match="!= 4 processes"):
        PAR.create_mesh((3, 1))
    with pytest.raises(ValueError, match="model_parallel 3"):
        PAR.create_hybrid_mesh(model_parallel=3)
    no_launch.setenv("LOCAL_WORLD_SIZE", "2")
    assert PAR.create_hybrid_mesh(model_parallel=2) == PAR.Mesh(2, 2)
    with pytest.raises(ValueError, match="must divide LOCAL_WORLD_SIZE 2"):
        PAR.create_mesh((1, 4))


def test_nccl_refuses_a_rank_without_a_card_of_its_own(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D._nccl_device(0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="local rank 1 has no card of its own"):
        D._nccl_device(1)


# ---------------------------------------------------------------------------
# Two gloo processes against one
# ---------------------------------------------------------------------------


def _feed(root, n, size):
    from PIL import Image

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))
    rng = np.random.default_rng(len(root))
    for i in range(n):
        Image.fromarray((rng.uniform(0, 1, size + (3,)) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i + 1:012d}.jpg"))
    with open(os.path.join(root, "annotations", "captions.json"), "w") as f:
        json.dump({str(i + 1): f"a photo number {i}" for i in range(n)}, f)
    return root


@contextlib.contextmanager
def _recording():
    """Record, in this process, what the CLIs edit and write: the parametric
    CLI's ``edit_batch`` outputs, the GAN edit's outputs, the diffusion CLI's
    batches, the training CLI's state, and every JPEG and ``torch.save``
    path."""
    from PIL import Image

    from rgie_tpu_torch.cli import adapt_images as AI
    from rgie_tpu_torch.cli import optimize_image_param as OP
    from rgie_tpu_torch.engine import gan as GE
    from rgie_tpu_torch.models import loader
    from rgie_tpu_torch.training import train_midu as TM

    rec = {"saved": [], "param": [], "gan": [], "diffusion": [], "train": []}

    def wrap(module, name, after):
        original = getattr(module, name)

        def wrapped(*args, **kwargs):
            out = original(*args, **kwargs)
            return after(out)
        mp.setattr(module, name, wrapped)

    def record(key, value):
        rec[key].append(value)

    with pytest.MonkeyPatch.context() as mp:
        save, torch_save = Image.Image.save, torch.save
        mp.setattr(Image.Image, "save", lambda self, fp, *a, **k: (
            record("saved", os.path.basename(str(fp))), save(self, fp, *a, **k))[1])
        mp.setattr(torch, "save", lambda obj, f, *a, **k: (
            record("saved", os.path.basename(str(f))), torch_save(obj, f, *a, **k))[1])
        load_va_loss = loader.load_va_loss
        mp.setattr(loader, "load_va_loss", lambda *a, **kw: load_va_loss(
            *a, **{"input_size": VA_SIZE, "crop_size": VA_CROP, **kw}))
        wrap(OP, "edit_batch", lambda out: (record("param", out.outputs.numpy()), out)[1])

        def gan_edit(edit):
            def run(*args):
                result, edited = edit(*args)
                record("gan", edited.numpy())
                return result, edited
            return run
        wrap(GE, "make_batched_edit", gan_edit)
        wrap(AI, "adapt_batches", lambda done: (rec["diffusion"].extend(
            (names, out.edited.numpy()) for names, out, _, _ in done), done)[1])
        wrap(TM, "shard_train_step", lambda pair: (record("train", pair[1]), pair)[1])
        yield rec


def _run_clis(work, tag):
    """The four CLIs on the CPU, their outputs under ``work/<cli>_<tag>``;
    returns what ``_recording`` saw, the trained midu's parameters in place
    of its state."""
    from rgie_tpu_torch.cli import adapt_images, optimize_image_imaginaire, optimize_image_param
    from rgie_tpu_torch.cli import train_guidance_clf

    with _recording() as rec:
        optimize_image_param.main([
            "--data-dir", os.path.join(work, "param_feed"),
            "--out-dir", os.path.join(work, f"param_{tag}"), "--num-steps", "2",
            "--input-size", "64", "--crop-size", "64", "--va-input-size", str(VA_SIZE),
            "--va-crop-size", str(VA_CROP), "--output-size", "96", "--batch", "2",
            "--adaptations", "pos:0.1", "--weight-recon", "0",
            "--va-model", os.path.join(work, "missing"),
            "--device", "cpu"])
        optimize_image_imaginaire.main([
            "--data-dir", os.path.join(work, "gan_feed"),
            "--out-dir", os.path.join(work, f"gan_{tag}"), "--num-steps", "2",
            "--input-size", "32", "--batch", "2", "--adaptations", "gan:0.1",
            "--va-model", os.path.join(work, "missing"),
            "--munit-model", os.path.join(work, "missing.pt"), "--device", "cpu"])
        adapt_images.main([
            "--scale", "tiny", "--device", "cpu", "--data-dir", os.path.join(work, "diff_feed"),
            "--batch", "2", "--num-steps", "2", "--input-size", "32",
            "--out-dir", os.path.join(work, f"diffusion_{tag}")])
        train_guidance_clf.main([
            "--scale", "tiny", "--device", "cpu", "--epochs", "1", "--num-batches", "2",
            "--val-batches", "1", "--batch-size", "4",
            "--out-dir", os.path.join(work, f"train_{tag}")])
    (state,) = rec.pop("train")
    rec["midu"] = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    return rec


def _ddp_step(midu_state, feats, labels):
    """One DDP step of the midu on this rank's half of ``feats``; rank 1
    starts from other weights, which ``shard_train_step``'s broadcast
    replaces. Returns the parameters, Adam's first moments and the loss."""
    from rgie_tpu_torch.config import TrainGuidanceConfig
    from rgie_tpu_torch.models.midu import MiduSD
    from rgie_tpu_torch.training.train_midu import create_train_state, shard_train_step

    rank, world = PAR.process_info()
    midu = MiduSD(2, MIDU_IN)
    midu.load_state_dict({k: torch.from_numpy(v) + rank for k, v in midu_state.items()})
    cfg = TrainGuidanceConfig(learning_rate=MIDU_LR, weight_decay=MIDU_WD)
    step, state = shard_train_step(create_train_state(midu, cfg))
    rows = slice(rank * len(feats) // world, (rank + 1) * len(feats) // world)
    state, loss, _ = step(state, torch.from_numpy(feats[rows]), torch.from_numpy(labels[rows]))
    moments = {name: state.optimizer.state[p]["exp_avg"].numpy().copy()
               for name, p in state.model.named_parameters()}
    return ({k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()},
            moments, float(loss))


def _rank_main(work, midu_state, feats, labels):
    torch.set_num_threads(2)
    ddp = _ddp_step(midu_state, feats, labels)
    return {"ddp": ddp, "clis": _run_clis(work, f"rank{PAR.process_info()[0]}")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from rgie_tpu_torch.models.midu import create_midu

    work = str(tmp_path_factory.mktemp("slice_f"))
    _feed(os.path.join(work, "param_feed"), 3, (80, 72))
    _feed(os.path.join(work, "gan_feed"), 3, (40, 36))
    _feed(os.path.join(work, "diff_feed"), 3, (40, 48))
    midu = create_midu(torch.Generator().manual_seed(0), in_channels=MIDU_IN)
    midu_state = {k: v.numpy().copy() for k, v in midu.state_dict().items()}
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((8, 8, 8, MIDU_IN)).astype(np.float32)
    labels = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    ranks = D.spawn_ranks(_rank_main, 2, work, midu_state, feats, labels, timeout=600)
    with pytest.MonkeyPatch.context() as mp:
        for var in LAUNCH_VARS:
            mp.delenv(var, raising=False)
        single = _run_clis(work, "single")
    return dict(work=work, ranks=ranks, single=single, midu_state=midu_state, feats=feats,
                labels=labels)


def test_ddp_midu_step_matches_jax_shard_train_step(runs):
    """The two ranks' step on 4 rows each against JAX's ``shard_train_step``
    on all 8 rows over the 8-device CPU mesh, from the same weights."""
    import jax
    import jax.numpy as jnp

    from rgie_tpu.config import TrainGuidanceConfig as TGC_j
    from rgie_tpu.models.midu import MiduSD as MiduSD_j
    from rgie_tpu.parallel.mesh import create_mesh
    from rgie_tpu.training import train_midu as TM_j
    from rgie_tpu.utils import torch_convert as TC

    midu_j, cfg_j = MiduSD_j(2), TGC_j(learning_rate=MIDU_LR, weight_decay=MIDU_WD)
    params_j = jax.tree.map(jnp.asarray, TC.convert_midu(runs["midu_state"], False))
    mesh = create_mesh()
    assert mesh.devices.size == 8
    step_j, state_j = TM_j.shard_train_step(
        TM_j.make_train_step(lambda p, f: midu_j.apply(p, f), cfg_j), mesh,
        TM_j.create_train_state(params_j, cfg_j))
    state_j, loss_j, _ = step_j(state_j, jnp.asarray(runs["feats"]), jnp.asarray(runs["labels"]))

    (params0, moments0, loss0), (params1, moments1, loss1) = (r["ddp"] for r in runs["ranks"])
    assert loss0 == loss1
    np.testing.assert_allclose(loss0, float(loss_j), rtol=1e-6)
    assert all(np.array_equal(params0[k], params1[k]) for k in params0)
    assert all(np.array_equal(moments0[k], moments1[k]) for k in moments0)
    got = TC.convert_midu(params0, False)["params"]
    first_moments = TC.convert_midu(moments0, False)["params"]
    mu_j = state_j.opt_state[1].mu["params"]
    for name, layer in got.items():
        for leaf, value in layer.items():
            expect = np.asarray(state_j.params["params"][name][leaf])
            np.testing.assert_allclose(value, expect, rtol=STEP_RTOL, atol=1e-2 * MIDU_LR)
            mu = np.asarray(mu_j[name][leaf])
            np.testing.assert_allclose(first_moments[name][leaf], mu,
                                       atol=STEP_RTOL * np.abs(mu).max())


def test_training_cli_keeps_one_midu_and_rank0_alone_writes(runs):
    (rank0, rank1), single = (r["clis"] for r in runs["ranks"]), runs["single"]
    assert all(np.array_equal(rank0["midu"][k], rank1["midu"][k]) for k in rank0["midu"])
    assert "best.pt" in rank0["saved"] and "best.pt" not in rank1["saved"]
    saved = torch.load(os.path.join(runs["work"], "train_rank0", "best.pt"))
    assert all(np.array_equal(saved[k].numpy(), rank0["midu"][k]) for k in saved)
    # Each rank drew its own rows: the two-rank midu is not the one-process one.
    assert not all(np.array_equal(rank0["midu"][k], single["midu"][k]) for k in single["midu"])


def test_param_cli_two_ranks_edit_their_own_rows_and_write_each_output_once(runs):
    """The repaired fault: under two ranks each process edits only its
    ``ShardedView`` rows (rank 0 items 1 and 3, rank 1 item 2) and every
    output file is written once, the same files as one process writes."""
    (rank0, rank1), single = (r["clis"] for r in runs["ranks"]), runs["single"]
    names = [f"{i:012d}_pos.jpg" for i in (1, 2, 3)]
    param0 = [n for n in rank0["saved"] if n.endswith("_pos.jpg")]
    param1 = [n for n in rank1["saved"] if n.endswith("_pos.jpg")]
    assert param0 == [names[0], names[2]] and param1 == [names[1]]
    assert sorted(n for n in single["saved"] if n.endswith("_pos.jpg")) == names
    assert sorted(os.listdir(os.path.join(runs["work"], "param_rank0"))
                  + os.listdir(os.path.join(runs["work"], "param_rank1"))) == names
    assert [r.shape[0] for r in rank0["param"]] == [1, 1] and len(rank1["param"]) == 1


def _rows(batches):
    return [row for batch in batches for row in batch]


@pytest.mark.parametrize("cli, rtol, atol", [("param", 1e-5, 1e-5), ("gan", 0, 1e-4)])
def test_cli_rows_match_one_process(runs, cli, rtol, atol):
    """Global batch 2 over two ranks (one image a rank) against one process
    at batch 2: rank 0's rows are images 1 and 3, rank 1's image 2."""
    (rank0, rank1), single = (r["clis"] for r in runs["ranks"]), runs["single"]
    expect = _rows(single[cli])
    got = {0: _rows(rank0[cli])[0], 1: _rows(rank1[cli])[0], 2: _rows(rank0[cli])[1]}
    assert len(expect) == 3 and len(_rows(rank0[cli])) == 2 and len(_rows(rank1[cli])) == 1
    for i, row in got.items():
        np.testing.assert_allclose(row, expect[i], rtol=rtol, atol=atol)


def test_diffusion_cli_rows_match_one_process(runs):
    (rank0, rank1), single = (r["clis"] for r in runs["ranks"]), runs["single"]
    expect = dict(zip(*map(_rows, zip(*single["diffusion"]))))
    got = dict(zip(*map(_rows, zip(*(rank0["diffusion"] + rank1["diffusion"])))))
    assert sorted(got) == sorted(expect) and len(expect) == 3
    assert [len(names) for names, _ in rank0["diffusion"] + rank1["diffusion"]] == [1, 1, 1]
    for name, row in got.items():
        np.testing.assert_allclose(row, expect[name], rtol=0,
                                   atol=1e-4 * np.abs(expect[name]).max())
    edits = [[n for n in r["saved"] if n.endswith(".jpg") and "_" not in n] for r in (rank0, rank1)]
    assert edits == [["000000000001.jpg", "000000000003.jpg"], ["000000000002.jpg"]]
