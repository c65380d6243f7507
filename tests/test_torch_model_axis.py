"""The model axis of the port against ``rgie_tpu`` on the CPU: tensor
parallelism over weight output channels (``parallel.create_mesh`` on
(data, model), ``model_sharding``, ``shard_model``).

Unit checks: ``model_sharding`` shards exactly the parameters JAX's
``model_sharding`` shards, along the axis where torch keeps JAX's last one
(the tiny UNet, VAE and midu at model 2 and 1, against a ``create_mesh``
of the 8 virtual CPU devices), ``rank_grid`` lays the ranks out as JAX's
meshes lay out the devices, with the refusals, and ``shard_model`` splits
an ``Embedding`` and a ``Conv2d`` and refuses a transposed convolution.

Then one module-scoped run of two ``gloo`` processes at (data, model) =
(1, 2): the column-parallel ``Linear`` and ``Conv2d`` against whole layers,
and the tiny float32 batched edit (null-text optimization with one image
stopping early, CFG, classifier guidance, a reference value per image) with
UNet, VAE and midu sharded, against the same edit in this process and
against JAX's ``make_batched_edit``; and one of four processes at (2, 2):
a midu training step against the one-process step on the union of the rows
and against JAX's ``make_train_step``.

Tolerances: a rank's edit against the one-process edit 5e-5 of the largest
entry (images, scores, null-text embeddings, latents, guidance norms): a
column slice sums each output over the same inputs, but the input gradient
is the sum of the ranks' partial products, in another order than one
product, and null-text optimization's normalized Adam steps and the
normalized guidance gradient carry that rounding on through the loops
(readings up to 1.7e-5; the same one-process edit on 1 and on 2 threads
differs by up to 7e-6 for the same reason). Against JAX as
``tests/test_torch_batched_edit.py`` holds the one-process edit: images
1e-3, scores 1e-4. The layers: 1e-6 of the largest entry. The training step
as ``tests/test_torch_parallel.py`` holds the data-parallel one
(``STEP_RTOL`` relative, parameters also 1e-2 of an Adam step absolute),
the loss 1e-6 relative. The ranks of a model group end bit-equal.
"""

import numpy as np
import pytest
import torch

from rgie_tpu_torch import parallel as PAR
from rgie_tpu_torch.parallel import distributed as D
from rgie_tpu_torch.parallel import model_axis as MA

torch.set_num_threads(2)

STEPS, INNER, SIZE, L, DIM = 2, 3, 32, 5, 32
KW = dict(guidance_scale=2.0, guidance_clf_scale=0.2, use_nto=True, use_reference=True,
          num_inner_steps=INNER)
EDIT_RTOL, LAYER_RTOL, STEP_RTOL = 5e-5, 1e-6, 1e-4
MIDU_IN, MIDU_LR, MIDU_WD = 16, 1e-3, 0.5


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _randomize_biases(module, g, scale=0.1):
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module


def _pipe():
    from rgie_tpu_torch.diffusion import schedulers as S
    from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline
    from rgie_tpu_torch.diffusion.unet import UNetConfig, create_unet
    from rgie_tpu_torch.diffusion.vae import VaeConfig, create_vae
    from rgie_tpu_torch.models.midu import create_midu

    g = torch.Generator().manual_seed(0)
    unet = _randomize_biases(create_unet(g, UNetConfig.tiny()), g, 0.02)
    vae = create_vae(g, VaeConfig.tiny())
    midu = _randomize_biases(create_midu(g, in_channels=16), g)
    return InversionResamplingPipeline(unet=unet, vae=vae, sched=S.make_schedule(STEPS),
                                       midu_model=midu)


def _inputs():
    """Two images, the shared empty embeddings, per-image conds and alphas."""
    from rgie_tpu_torch.diffusion.batched import BatchedConds

    rng = np.random.default_rng(1)

    def arr(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))

    images = torch.from_numpy(rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    empty = arr(1, L, DIM, s=0.5)
    per_image = [BatchedConds(cfg_embeds=arr(2, L, DIM, s=0.5), cond_embeds=arr(1, L, DIM, s=0.5))
                 for _ in range(2)]
    return images, empty, per_image, torch.tensor([[0.1, 0.1], [-0.1, 0.2]])


def _modules(pipe):
    return {"unet": pipe.unet, "vae": pipe.vae, "midu": pipe.midu_model}


def _bytes(module):
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _edit(pipe, epsilon):
    """The batched edit of ``_inputs``: its outputs, the null-text steps and
    the tensors the ranks must agree on."""
    from rgie_tpu_torch.diffusion.batched import make_batched_edit, stack_conds
    from rgie_tpu_torch.diffusion.pipeline import RunLog

    images, empty, per_image, alphas = _inputs()
    log = RunLog()
    out = make_batched_edit(pipe, **KW, nto_epsilon=epsilon)(images, empty, stack_conds(per_image),
                                                             alphas, log=log)
    return {"edited": out.edited, "orig_score": out.orig_score,
            "adapted_score": out.adapted_score, "steps": log.nto_image_steps,
            **{k: log.tensors[k] for k in ("nto_embeds", "nto_adam_m", "nto_adam_v",
                                           "out_latents")},
            "norms": torch.stack(log.clf_grad_norms)}


def _first_losses(pipe):
    """Each image's first null-text loss (outer step 0, the embeddings at
    empty): an epsilon between them stops one image early."""
    images, empty, per_image, _ = _inputs()
    lat = pipe.encode_image(images)
    _, pivots = pipe.reverse_sample(lat, empty.expand(2, -1, -1))
    t = int(pipe.sched.timesteps[0])
    cond = torch.cat([c.cond_embeds for c in per_image])
    with torch.no_grad():
        eps_cond, _ = pipe._unet(pivots[-1], t, cond, None)
    losses, _ = pipe.null_inner_loss_and_grad(empty.expand(2, -1, -1), pivots[-1], t, eps_cond,
                                              pivots[-2], 2.0)
    return losses


# ---------------------------------------------------------------------------
# Unit checks
# ---------------------------------------------------------------------------


def _jax_trees(pipe):
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.utils import torch_convert as TC

    return {"unet": TC.convert_unet_diffusers(_np_state(pipe.unet), U_j.UNetConfig.tiny()),
            "vae": TC.convert_vae_diffusers(_np_state(pipe.vae), V_j.VaeConfig.tiny()),
            "midu": TC.convert_midu(_np_state(pipe.midu_model), False)}


@pytest.mark.parametrize("model", [2, 1])
@pytest.mark.parametrize("name", ["unet", "vae", "midu"])
def test_model_sharding_matches_jax(name, model):
    """Each JAX leaf is filled with the index (from 1) of the model rank that
    holds each entry where JAX's ``model_sharding`` shards it, 0 where it
    replicates, and carried to torch's layout by ``utils/from_jax``: every
    port parameter must then read its own placement's owners."""
    import jax

    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.parallel.mesh import create_mesh as create_mesh_j
    from rgie_tpu.parallel.mesh import model_sharding as model_sharding_j
    from rgie_tpu_torch.utils import from_jax

    pipe = _pipe()
    mesh_j = create_mesh_j((8 // model, model))
    mesh = PAR.Mesh(8 // model, model)

    def owners(x):
        spec = model_sharding_j(x, mesh_j).spec
        if all(s is None for s in spec):
            return np.zeros(x.shape, np.float32)
        assert tuple(spec) == (None,) * (x.ndim - 1) + ("model",)
        n = x.shape[-1]
        return np.broadcast_to(np.arange(n) // (n // model) + 1.0, x.shape).astype(np.float32)

    tree = jax.tree.map(owners, _jax_trees(pipe)[name])
    to_torch = {"unet": lambda t: from_jax.unet_state_dict(t, U_j.UNetConfig.tiny()),
                "vae": lambda t: from_jax.vae_state_dict(t, V_j.VaeConfig.tiny()),
                "midu": lambda t: from_jax.midu_state_dict(t, False)}[name]
    expect = to_torch(tree)
    module, sharded = _modules(pipe)[name], 0
    for prefix, sub in module.named_modules():
        for leaf, p in sub.named_parameters(recurse=False):
            key = f"{prefix}.{leaf}" if prefix else leaf
            data_place, model_place = PAR.model_sharding(p, mesh, sub)
            assert isinstance(data_place, torch.distributed.tensor.Replicate)
            if isinstance(model_place, torch.distributed.tensor.Shard):
                k, n = model_place.dim, p.shape[model_place.dim]
                shape = [1] * p.ndim
                shape[k] = n
                want = torch.broadcast_to((torch.arange(n) // (n // model) + 1.0).view(shape),
                                          p.shape)
                sharded += 1
            else:
                want = torch.zeros(p.shape)
            assert torch.equal(expect.pop(key), want), key
    assert not expect
    assert (sharded > 0) == (model > 1)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_rank_grid_matches_jax_device_grids(shape):
    import jax

    from rgie_tpu.parallel.distributed import create_hybrid_mesh as create_hybrid_mesh_j
    from rgie_tpu.parallel.mesh import create_mesh as create_mesh_j

    ids = np.vectorize(lambda d: d.id)
    grid = PAR.rank_grid(8, 8, shape[1])
    assert grid.shape == shape
    assert np.array_equal(grid, ids(create_mesh_j(shape).devices))
    assert np.array_equal(grid, ids(create_hybrid_mesh_j(model_parallel=shape[1]).devices))
    assert [d.id for d in jax.devices()] == list(range(8))


def test_rank_grid_refusals():
    with pytest.raises(ValueError, match="model_parallel 3 !| 8 processes"):
        PAR.rank_grid(8, 8, 3)
    with pytest.raises(ValueError, match="must divide LOCAL_WORLD_SIZE 2"):
        PAR.rank_grid(8, 2, 4)
    assert PAR.rank_grid(8, 2, 2).tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_a_model_axis_of_one_shards_nothing():
    pipe = _pipe()
    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    assert PAR.shard_model(pipe.unet, PAR.Mesh(1, 1)) is pipe.unet
    assert PAR.model_axis_of(pipe.unet) is None and not MA.model_shards(pipe.unet)
    assert all(torch.equal(before[k], v) for k, v in pipe.unet.state_dict().items())


def test_shard_model_splits_what_it_can_and_refuses_the_rest():
    """No collective runs while sharding, so a mesh without groups will do:
    an ``Embedding`` table keeps its column slice and is gathered for its
    forward, a ``Conv2d`` its output channels; a transposed convolution
    (output channels in dim 1, where the rule does not look) is refused."""
    mesh = PAR.Mesh(1, 2, groups=(None, None))
    net = torch.nn.Sequential(torch.nn.Embedding(10, 8), torch.nn.Conv2d(3, 8, 3))
    PAR.shard_model(net, mesh)
    assert net[0].weight.shape == (10, 4) and net[1].weight.shape == (4, 3, 3, 3)
    assert isinstance(net[0], MA._GatheredParameters) and isinstance(net[1], MA._ColumnParallel)
    assert MA.model_shards(net) == {"0.weight": (1, 8), "1.weight": (0, 8), "1.bias": (0, 8)}
    with pytest.raises(NotImplementedError, match="ConvTranspose2d"):
        PAR.shard_model(torch.nn.ConvTranspose2d(4, 8, 3), mesh)


# ---------------------------------------------------------------------------
# Two gloo processes at (1, 2)
# ---------------------------------------------------------------------------


def _layers_rank():
    """A ``Linear`` and a ``Conv2d`` sharded against the whole layers: the
    outputs, the input gradients and the weight gradients (this rank's
    slice of the whole one's)."""
    mesh = PAR.create_mesh((1, 2))
    _, j = mesh.coords()
    g = torch.Generator().manual_seed(3)
    out = {}
    for name, make, shape in (("linear", lambda: torch.nn.Linear(6, 8), (3, 5, 6)),
                              ("conv", lambda: torch.nn.Conv2d(3, 8, 3, padding=1), (2, 3, 5, 5))):
        whole = make()
        with torch.no_grad():
            for p in whole.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        part = make()
        part.load_state_dict(whole.state_dict())
        PAR.shard_model(part, mesh)
        x = torch.randn(shape, generator=g)
        w = torch.randn(whole(x).shape, generator=g)
        results = []
        for layer in (whole, part):
            xi = x.clone().requires_grad_(True)
            y = layer(xi)
            (y * w).sum().backward()
            results.append((y.detach(), xi.grad, layer.weight.grad, layer.bias.grad))
        (y0, dx0, dw0, db0), (y1, dx1, dw1, db1) = results
        out[name] = dict(
            local_rows=part.weight.shape[0], y=float((y1 - y0).abs().max() / y0.abs().max()),
            dx=float((dx1 - dx0).abs().max() / dx0.abs().max()),
            dw=float((dw1 - dw0[4 * j:4 * j + 4]).abs().max() / dw0.abs().max()),
            db=float((db1 - db0[4 * j:4 * j + 4]).abs().max() / db0.abs().max()),
            state=all(torch.equal(a, b) for a, b in zip(part.state_dict().values(),
                                                       whole.state_dict().values())))
    return out


def _edit_rank(epsilon):
    torch.set_num_threads(1)
    layers = _layers_rank()
    mesh = PAR.create_mesh((1, 2))
    pipe = _pipe()
    whole = {name: (_bytes(m), _np_state(m)) for name, m in _modules(pipe).items()}
    for m in _modules(pipe).values():
        PAR.shard_model(m, mesh)
    bytes_ = {}
    for name, m in _modules(pipe).items():
        shards = MA.model_shards(m)
        params = dict(m.named_parameters())
        local = sum(params[k].numel() * params[k].element_size() for k in shards)
        full = sum(int(np.prod(params[k].shape)) // params[k].shape[dim] * n
                   * params[k].element_size() for k, (dim, n) in shards.items())
        bytes_[name] = dict(local=_bytes(m), whole=whole[name][0], sharded_local=local,
                            sharded_whole=full)
    state_equal = {name: all(np.array_equal(v, whole[name][1][k])
                             for k, v in _np_state(m).items())
                   for name, m in _modules(pipe).items()}
    # A full checkpoint loads into the sharded module: each rank keeps its slice.
    unet_local = {k: v.clone() for k, v in pipe.unet.named_parameters()}
    pipe.unet.load_state_dict({k: torch.from_numpy(v) for k, v in whole["unet"][1].items()})
    reloaded = all(torch.equal(v, unet_local[k]) for k, v in pipe.unet.named_parameters())
    edit = _edit(pipe, epsilon)
    return dict(layers=layers, bytes=bytes_, state_equal=state_equal, reloaded=reloaded,
                edit={k: v if isinstance(v, list) else v.numpy() for k, v in edit.items()})


@pytest.fixture(scope="module")
def edit_runs():
    pipe = _pipe()
    losses = _first_losses(pipe)
    lo, hi = sorted(losses.tolist())
    assert hi > 1.05 * lo, losses
    epsilon = (lo * hi) ** 0.5
    ranks = D.spawn_ranks(_edit_rank, 2, epsilon, timeout=600)
    one = {k: v if isinstance(v, list) else v.numpy() for k, v in _edit(pipe, epsilon).items()}
    return dict(pipe=pipe, epsilon=epsilon, losses=losses, ranks=ranks, one=one)


def test_column_parallel_layers_match_whole_layers(edit_runs):
    for rank in edit_runs["ranks"]:
        for name, got in rank["layers"].items():
            assert got["local_rows"] == 4, name           # 8 outputs, 4 on each rank
            assert got["state"], name                      # state_dict() gathers them whole
            for key in ("y", "dx", "dw", "db"):
                assert got[key] <= LAYER_RTOL, (name, key, got[key])


def test_ranks_hold_half_the_sharded_weights(edit_runs):
    for rank in edit_runs["ranks"]:
        for name, b in rank["bytes"].items():
            assert 2 * b["sharded_local"] == b["sharded_whole"] > 0, name
            assert b["local"] == b["whole"] - b["sharded_local"], name
        total = sum(b["local"] for b in rank["bytes"].values())
        whole = sum(b["whole"] for b in rank["bytes"].values())
        assert total <= 0.55 * whole, (total, whole)
        assert all(rank["state_equal"].values()) and rank["reloaded"]


def test_model_ranks_are_bit_equal(edit_runs):
    (r0, r1) = (r["edit"] for r in edit_runs["ranks"])
    assert r0["steps"] == r1["steps"]
    for key in r0:
        if key != "steps":
            assert np.array_equal(r0[key], r1[key]), key


def test_tensor_parallel_edit_matches_one_process(edit_runs):
    """One image stops null-text optimization after one inner step at the
    first outer step, the other runs on, on the ranks as in one process."""
    one, losses = edit_runs["one"], edit_runs["losses"]
    first = one["steps"][0]
    assert first[int(np.argmin(losses.numpy()))] == 1 and max(first) == INNER
    for rank in edit_runs["ranks"]:
        got = rank["edit"]
        assert got["steps"] == one["steps"]
        for key in ("edited", "orig_score", "adapted_score", "nto_embeds", "out_latents", "norms"):
            np.testing.assert_allclose(got[key], one[key], rtol=0,
                                       atol=EDIT_RTOL * np.abs(one[key]).max(), err_msg=key)


def test_tensor_parallel_edit_matches_jax(edit_runs):
    import jax
    import jax.numpy as jnp

    from rgie_tpu.diffusion import batched as B_j
    from rgie_tpu.diffusion import pipeline as P_j
    from rgie_tpu.diffusion import schedulers as S_j
    from rgie_tpu.diffusion import unet as U_j
    from rgie_tpu.diffusion import vae as V_j
    from rgie_tpu.models import midu as M_j

    trees = jax.tree.map(jnp.asarray, _jax_trees(edit_runs["pipe"]))
    params_j = P_j.PipelineParams(unet=trees["unet"], vae=trees["vae"], midu=trees["midu"])
    pipe_j = P_j.InversionResamplingPipeline(
        unet=U_j.UNet2DCondition(U_j.UNetConfig.tiny()),
        vae=V_j.AutoencoderKL(V_j.VaeConfig.tiny()), sched=S_j.make_schedule(STEPS),
        midu_model=M_j.MiduSD(2))
    images, empty, per_image, alphas = _inputs()
    conds_j = B_j.stack_conds([B_j.BatchedConds(cfg_embeds=jnp.asarray(c.cfg_embeds.numpy()),
                                                cond_embeds=jnp.asarray(c.cond_embeds.numpy()))
                               for c in per_image])
    expect = jax.jit(B_j.make_batched_edit(pipe_j, **KW, nto_epsilon=edit_runs["epsilon"]))(
        params_j, jnp.asarray(images.numpy()), jnp.asarray(empty.numpy()), conds_j,
        jnp.asarray(alphas.numpy()))
    for rank in edit_runs["ranks"]:
        got = rank["edit"]
        np.testing.assert_allclose(got["orig_score"], np.asarray(expect.orig_score), atol=1e-4)
        np.testing.assert_allclose(got["edited"], np.asarray(expect.edited), atol=1e-3)
        np.testing.assert_allclose(got["adapted_score"], np.asarray(expect.adapted_score),
                                   atol=1e-4)
    assert float(np.abs(got["edited"] - images.numpy()).mean()) > 1e-3


# ---------------------------------------------------------------------------
# Four gloo processes at (2, 2)
# ---------------------------------------------------------------------------


def _train_data():
    from rgie_tpu_torch.models.midu import create_midu

    midu = create_midu(torch.Generator().manual_seed(0), in_channels=MIDU_IN)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((8, 8, 8, MIDU_IN)).astype(np.float32)
    labels = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    return midu, feats, labels


def _train_rank():
    """One step of the sharded midu on this data group's half of the rows;
    the second data group starts from other weights, which
    ``shard_train_step``'s broadcasts replace."""
    from rgie_tpu_torch.config import TrainGuidanceConfig
    from rgie_tpu_torch.training.train_midu import create_train_state, shard_train_step

    torch.set_num_threads(1)
    mesh = PAR.create_mesh((2, 2))
    d, j = mesh.coords()
    midu, feats, labels = _train_data()
    PAR.shard_model(midu, mesh)
    with torch.no_grad():
        for p in midu.parameters():
            p.add_(d)
    cfg = TrainGuidanceConfig(learning_rate=MIDU_LR, weight_decay=MIDU_WD)
    step, state = shard_train_step(create_train_state(midu, cfg), mesh)
    rows = slice(d * 4, d * 4 + 4)
    state, loss, _ = step(state, torch.from_numpy(feats[rows]), torch.from_numpy(labels[rows]))
    return dict(coords=(d, j), loss=float(loss), state=_np_state(state.model),
                shards=MA.model_shards(state.model),
                local={n: p.detach().numpy().copy() for n, p in state.model.named_parameters()},
                moments={n: state.optimizer.state[p]["exp_avg"].numpy().copy()
                         for n, p in state.model.named_parameters()})


@pytest.fixture(scope="module")
def train_runs():
    from rgie_tpu_torch.config import TrainGuidanceConfig
    from rgie_tpu_torch.training.train_midu import create_train_state, make_train_step

    ranks = D.spawn_ranks(_train_rank, 4, timeout=600)
    midu, feats, labels = _train_data()
    cfg = TrainGuidanceConfig(learning_rate=MIDU_LR, weight_decay=MIDU_WD)
    state, loss, _ = make_train_step()(create_train_state(midu, cfg), torch.from_numpy(feats),
                                       torch.from_numpy(labels))
    return dict(ranks=ranks, one=(_np_state(state.model), float(loss)), feats=feats,
                labels=labels)


def test_train_ranks_keep_their_slices_and_one_midu(train_runs):
    ranks = train_runs["ranks"]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert sorted(ranks[0]["shards"]) == ["0.bias", "0.weight", "3.bias", "3.weight", "7.bias",
                                          "7.weight"]                   # 9.* has 2 outputs
    assert len({r["loss"] for r in ranks}) == 1
    for r in ranks[1:]:
        assert all(np.array_equal(v, ranks[0]["state"][k]) for k, v in r["state"].items())
    # the two data groups hold the same slices, the two model ranks their own
    for a, b in ((0, 2), (1, 3)):
        assert all(np.array_equal(ranks[a]["local"][k], ranks[b]["local"][k])
                   for k in ranks[a]["local"])
        assert all(np.array_equal(ranks[a]["moments"][k], ranks[b]["moments"][k])
                   for k in ranks[a]["moments"])
    assert not np.array_equal(ranks[0]["local"]["0.weight"], ranks[1]["local"]["0.weight"])


def test_train_step_matches_one_process_on_the_union(train_runs):
    state, loss = train_runs["one"]
    got = train_runs["ranks"][0]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    for k, v in got["state"].items():
        np.testing.assert_allclose(v, state[k], rtol=STEP_RTOL, atol=1e-2 * MIDU_LR, err_msg=k)


def test_train_step_matches_jax(train_runs):
    import jax
    import jax.numpy as jnp

    from rgie_tpu.config import TrainGuidanceConfig as TGC_j
    from rgie_tpu.models.midu import MiduSD as MiduSD_j
    from rgie_tpu.training import train_midu as TM_j
    from rgie_tpu.utils import torch_convert as TC

    midu, _, _ = _train_data()
    midu_j, cfg_j = MiduSD_j(2), TGC_j(learning_rate=MIDU_LR, weight_decay=MIDU_WD)
    state_j = TM_j.create_train_state(
        jax.tree.map(jnp.asarray, TC.convert_midu(_np_state(midu), False)), cfg_j)
    step_j = jax.jit(TM_j.make_train_step(lambda p, f: midu_j.apply(p, f), cfg_j))
    state_j, loss_j, _ = step_j(state_j, jnp.asarray(train_runs["feats"]),
                                jnp.asarray(train_runs["labels"]))
    got = train_runs["ranks"][0]
    np.testing.assert_allclose(got["loss"], float(loss_j), rtol=1e-6)
    params = TC.convert_midu(got["state"], False)["params"]
    for name, layer in params.items():
        for leaf, value in layer.items():
            expect = np.asarray(state_j.params["params"][name][leaf])
            np.testing.assert_allclose(value, expect, rtol=STEP_RTOL, atol=1e-2 * MIDU_LR,
                                       err_msg=f"{name}.{leaf}")
