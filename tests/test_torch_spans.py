"""The port's profiler ranges (``utils/spans.py``) on the CPU, tiny configs.

Off, no range is opened: with ``record_function`` made to raise, the batched
edit and a training step still run. On (the CPU profiler recording
user-scope ranges only), the ranges of the SD and SDXL batched edits and of
midu training nest as ``utils/spans.py`` lists them, there is one
``nto.inner`` range per inner iteration ``RunLog`` counted, one ``attn.*``
range per attention call (its name says the call's route, type and shape),
and each ``edit.*`` range lasts what ``RunLog.seconds`` charged its phase,
within 2 % or 1 ms, whichever is larger (the range ends a few microseconds
after the phase's lap).
"""

import re

import numpy as np
import pytest
import torch

from rgie_tpu_torch.cli import train_guidance_clf as T
from rgie_tpu_torch.diffusion import schedulers as S
from rgie_tpu_torch.diffusion import unet as U
from rgie_tpu_torch.diffusion import vae as V
from rgie_tpu_torch.diffusion.batched import BatchedConds, make_batched_edit
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline, RunLog, SdxlCond
from rgie_tpu_torch.models.midu import create_midu
from rgie_tpu_torch.training.train_midu import create_train_state, make_train_step

torch.set_num_threads(2)

STEPS, INNER, SIZE, L, D, B = 2, 3, 32, 5, 32, 2
PHASES = ["score", "encode", "invert", "nto", "sample", "decode", "rescore"]
#: Each range and the range it must lie directly inside.
PARENTS = {"nto.outer": "edit.nto", "nto.cond": "nto.outer", "nto.inner": "nto.outer",
           "nto.cfg_step": "nto.outer", "nto.loss_grad": "nto.inner", "nto.adam": "nto.inner",
           "nto.readback": "nto.inner", "sample.step": "edit.sample",
           "sample.cfg": "sample.step", "sample.sched": "sample.step",
           "sample.guidance": "sample.step"}
ATTN = re.compile(r"^attn\.(k2|matmul)\.(\w+)\.(\d+)x(\d+)x(\d+)x(\d+)x(\d+)$")


def recorded(fn):
    """``fn()`` under the profiler recording user-scope ranges only; returns
    its result and the ranges as sorted (start_ns, end_ns, name)."""
    from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig
    from torch.autograd.profiler import (ProfilerConfig, ProfilerState, _disable_profiler,
                                         _enable_profiler, _prepare_profiler)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    activities = {ProfilerActivity.CPU}
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        out = fn()
    finally:
        result = _disable_profiler()
    return out, sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                       for e in result.events())


def parents(ranges):
    """Each range with the name of the innermost range that holds it (None
    at the top)."""
    out, open_ = [], []
    for s, e, name in ranges:
        while open_ and open_[-1][1] < e:
            open_.pop()
        out.append((s, e, name, open_[-1][2] if open_ else None))
        open_.append((s, e, name))
    return out


def tiny_edit(xl: bool):
    """The tiny SD edit (DDIM) or SDXL edit (karras DPM, added conds) of two
    images, null-text optimization and guidance on; returns its pipeline and
    a function that runs it once and returns its ``RunLog``."""
    g = torch.Generator().manual_seed(0)
    cfg = U.UNetConfig.tiny_xl() if xl else U.UNetConfig.tiny()
    sig = {}
    if xl:
        sig = {name: S.make_dpm_sigma_schedule(STEPS, use_karras_sigmas=True, inverse=inverse)
               for name, inverse in (("sigma_sched", False), ("sigma_sched_inv", True))}
    pipe = InversionResamplingPipeline(
        unet=U.create_unet(g, cfg), vae=V.create_vae(g, V.VaeConfig.tiny()),
        sched=S.make_schedule(STEPS), midu_model=create_midu(g, in_channels=16), is_xl=xl,
        scheduler_type="dpm" if xl else "ddim", **sig)
    rng = np.random.default_rng(1)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.5)

    images = torch.from_numpy(rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32))
    conds, added_empty = BatchedConds(arr(B, 2, L, D), arr(B, 1, L, D)), None
    if xl:
        ids = torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]], dtype=torch.float32)
        pooled = cfg.addition_pooled_dim

        def added(n):
            return SdxlCond(arr(B, n, pooled), ids.expand(B, n, 6))

        conds = conds._replace(added_cfg=added(2), added_cond=added(1), added_uncond=added(1))
        added_empty = SdxlCond(arr(1, pooled), ids)
    program = make_batched_edit(pipe, guidance_scale=2.0, guidance_clf_scale=0.2,
                                num_inner_steps=INNER)
    empty, alphas = arr(1, L, D), torch.zeros(B, 2)

    def run():
        log = RunLog()
        program(images, empty, conds, alphas, added_empty, log=log)
        return log

    return pipe, run


def tiny_training():
    """``features_and_labels`` and one midu training step at the tiny scale;
    returns a function that runs both once."""
    args = T.build_parser().parse_args(["--scale", "tiny", "--device", "cpu",
                                        "--batch-size", "2"])
    stack, midu = T.build_models(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    state, step = create_train_state(midu, T.TrainGuidanceConfig()), make_train_step()
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))

    def run():
        feats, labels = T.features_and_labels(stack, torch.Generator().manual_seed(7), images)
        step(state, feats, labels)

    return run


@pytest.fixture(scope="module", params=[False, True], ids=["sd", "sdxl"])
def edit(request):
    pipe, run = tiny_edit(request.param)
    run()                   # the first call's one-time costs, outside the record
    log, ranges = recorded(run)
    return pipe, run, log, ranges


def test_ranges_off_open_nothing(monkeypatch):
    """Without a profiler the program never reaches ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    log = tiny_edit(False)[1]()
    assert list(log.seconds) == PHASES and sum(log.nto_inner_steps) > 0
    tiny_training()()


def test_phase_and_loop_ranges_nest(edit):
    ranges = edit[3]
    tree = parents(ranges)
    phases = [name for _, _, name, parent in tree if parent is None]
    assert phases == [f"edit.{p}" for p in PHASES]
    for _, _, name, parent in tree:
        if name in PARENTS:
            assert parent == PARENTS[name], (name, parent)
    names = [name for _, _, name, _ in tree]
    for name in PARENTS:
        assert name in names
    assert names.count("sample.step") == STEPS and names.count("nto.outer") == STEPS


def test_one_inner_range_per_inner_iteration(edit):
    _, _, log, ranges = edit
    names = [name for _, _, name in ranges]
    assert names.count("nto.inner") == sum(log.nto_inner_steps) > STEPS
    for part in ("nto.loss_grad", "nto.adam", "nto.readback"):
        assert names.count(part) == sum(log.nto_inner_steps)


def test_phase_ranges_last_what_the_run_log_charged(edit):
    _, _, log, ranges = edit
    lengths = {name[len("edit."):]: (e - s) * 1e-9 for s, e, name in ranges
               if name.startswith("edit.")}
    assert set(lengths) == set(log.seconds)
    for phase, seconds in log.seconds.items():
        assert lengths[phase] == pytest.approx(seconds, rel=0.02, abs=1e-3), phase


@pytest.mark.parametrize("k2", [False, True], ids=["gate", "k2_everywhere"])
def test_attention_ranges_name_each_call(edit, monkeypatch, k2):
    """One ``attn.*`` range per attention call, named by its route, type and
    (B, H, N, M, d). With the gate opened for every self-attention, those
    calls take the flash-attention route (its plain version on the CPU) and
    say ``k2``."""
    pipe, run = edit[:2]
    if k2:
        for module in (U, V):
            monkeypatch.setattr(module, "flash_self_attention_ok", lambda n, m, d: n == m)
    calls = []

    def hook(module, args, kwargs, out):
        x = args[0]
        if isinstance(module, V.VaeAttention):
            b, c, h, w = x.shape
            calls.append((b, 1, h * w, h * w, c, True))
        else:
            context = args[1] if len(args) > 1 else kwargs.get("context")
            context = x if context is None else context
            calls.append((x.shape[0], module.heads, x.shape[1], context.shape[1],
                          module.dim_head, context is x))

    handles = [m.register_forward_hook(hook, with_kwargs=True) for net in (pipe.unet, pipe.vae)
               for m in net.modules() if isinstance(m, (U.CrossAttention, V.VaeAttention))]
    try:
        _, ranges = recorded(run)
    finally:
        for h in handles:
            h.remove()
    named = [ATTN.match(name) for _, _, name in ranges if name.startswith("attn.")]
    assert all(named) and len(named) == len(calls) > 0
    for match, (b, h, n, m, d, self_attn) in zip(named, calls):
        route, dtype, *shape = match.groups()
        assert [int(x) for x in shape] == [b, h, n, m, d]
        assert dtype == "f32"
        assert route == ("k2" if k2 and self_attn else "matmul")


def test_training_ranges_nest():
    run = tiny_training()
    _, ranges = recorded(run)
    tree = parents(ranges)
    names = [(name, parent) for _, _, name, parent in tree if name.startswith("train.")]
    assert names == [("train.features", None), ("train.teacher", "train.features"),
                     ("train.encode", "train.features"), ("train.unet", "train.features"),
                     ("train.step", None)]
    attention = [parent for _, _, name, parent in tree if name.startswith("attn.")]
    assert attention and set(attention) <= {"train.encode", "train.unet"}
