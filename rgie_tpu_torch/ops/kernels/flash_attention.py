"""Kernel K2: flash attention (forward, backward dK/dV, backward dQ), its
wrapper with a gradient, and its plain PyTorch version.

Replaces the three TPU kernels of
``jax/experimental/pallas/ops/tpu/flash_attention.py`` that the JAX package
reaches from ``rgie_tpu/diffusion/unet.py`` (UNet self-attention) and
``rgie_tpu/diffusion/vae.py`` (VAE mid-block attention): ``flash_attention``
-> ``_flash_attention_impl``, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``. The kernels are CUDA C++ in
``rgie_tpu_torch/csrc/flash_attention_{fwd,bwd_dkv,bwd_dq}.cu`` (each source
carries its own note on what bounds it and what its design does about that).
They are compiled with ``nvcc`` at the first launch (``build.py``) and called
through ``ctypes`` on PyTorch's current stream.

Dispatch: CPU tensors run ``reference_flash_attention`` (tiled, the same
online softmax, the same log-sum-exp residual, a hand-written backward with
the kernels' formulas); CUDA tensors launch the kernels or raise. There is
no fallback between the two.

Inside each C entry point a second dispatch goes by shape, the rule
``kernel_route(kernel, dtype, width)`` names the kernel it runs:

- ``"tensor"``: bfloat16 at head widths that are multiples of 8 up to 128,
  in all three (``wgmma``, bfloat16 tiles in shared memory, ``cp.async``
  ring);
- ``"wide"``: bfloat16 at widths above 128 that are multiples of 64, up to
  512 (the VAE's single 512-wide head), in all three, on the tensor cores:
  the forward and dQ with 64 query rows a block, their output split by
  columns over two warpgroups that each compute the whole score tile; dK/dV
  with 64 keys a block, K and V resident, 16-query tiles streamed, the
  output columns split over ``grid.z`` above width 256 and over the two
  warpgroups;
- ``"float32"``: all three at every float32 width, on the CUDA cores with a
  ``cp.async`` ring, the query tile (forward, dQ) or the key tile (dK/dV)
  resident, and 8 x 8 or 8 x 16 register patches, a tile's products split
  over the block's warps; above width 128 dK/dV and dQ run their wide
  kernels (``flash_bwd_dkv_float32_wide_kernel``,
  ``flash_bwd_dq_float32_wide_kernel``: whole head rows resident, 32 keys or
  query rows a block, the score products split over a warp's lanes);
- ``"cuda_cores"``: the bfloat16 widths the tensor-core kernels do not take,
  on the first CUDA-core kernels, which widen bfloat16 to float32 in shared
  memory.

A launch that fails raises.

The modules' gate (``flash_self_attention_ok``) sends self-attention to the
kernels from 256 positions at head widths that are multiples of 8 up to 64
(bfloat16 on the tensor cores, float32 on the narrow forward) and from 8192
at every other width the kernels take: the crossovers measured on the H100
by ``cli/check_flash_attn.py``, where the JAX package keeps the TPU's 8192
for every width. It also reads the
environment variable ``RGIE_FLASH_ATTN`` once, when this module is imported,
as the JAX package does: ``"0"`` closes the gate, so the attention modules
take their matmul route on any device; any other value (``"auto"`` when
unset) leaves the gate as it is.

Rounding in bfloat16, as in the TPU kernels: the products take bfloat16
operands and sum in float32; the probabilities P and the score gradients dS
are rounded to bfloat16 before the second product (``p.astype(v.dtype)``,
``ds.astype(k.dtype)`` there). Row maxima, row sums, the log-sum-exp and
``di`` stay float32. The plain version rounds at the same points; for float32
inputs the rounding is the identity.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Tuple

import torch

from rgie_tpu_torch.ops.kernels import build

#: Kernel launches, one per call of the matching kernel on CUDA tensors. A run
#: sets them to 0 before the path it wants to check and reads them after.
LAUNCHES_FWD = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0

KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
#: The three kernels by their short names: "fwd", "bwd_dkv", "bwd_dq".
KERNELS = tuple(name.removeprefix("flash_attention_") for name in KERNEL_SOURCES)

#: Self-attention over at least this many positions takes the kernels at the
#: head widths where bfloat16 runs on the tensor cores and float32 on the
#: narrow forward (multiples of 8 up to ``FLOAT32_NARROW_FWD_WIDTH``; the
#: UNet's heads are 64 wide). Timed on the H100 (``cli/check_flash_attn.py``):
#: from 256 positions the kernels beat the matmul route forward and forward +
#: backward at the batched edit's batches; at 64 positions they lose forward
#: + backward at batch 16. At width 128 bfloat16 wins too, but the float32
#: forward's wide kernel loses at every length timed, up to 4096.
MIN_FLASH_SEQ_LEN = 256
#: The same at every other width the kernels take (the VAE's single 512-wide
#: head; bfloat16 widths off the tensor cores): at 4096 positions the wide
#: kernels lose forward + backward to the matmul route; at 16384 they win.
MIN_FLASH_SEQ_LEN_WIDE = 8192
#: The widest head of the tensor-core kernels; wider ones take the wide
#: kernels.
NARROW_HEAD_WIDTH = 128
#: The widest head of the float32 forward's narrow kernel
#: (``flash_fwd_float32_kernel``); wider ones take its wide kernel.
FLOAT32_NARROW_FWD_WIDTH = 64
MAX_HEAD_WIDTH = 512
#: The kernels launch one block row per (batch, head) pair, in a grid
#: dimension of at most this many blocks.
MAX_BATCH_HEADS = 65535


def head_width_supported(width: int) -> bool:
    """The kernels take any head width that is a multiple of 4 up to 512."""
    return 0 < width <= MAX_HEAD_WIDTH and width % 4 == 0


#: ``"0"`` sends the attention modules to their matmul route whatever the
#: shape; any other value leaves the gate as it is (the JAX package's switch,
#: ``rgie_tpu/diffusion/unet.py:159-164``).
FLASH_ATTN = os.environ.get("RGIE_FLASH_ATTN", "auto")

def kernel_route(kernel: str, dtype: torch.dtype, width: int) -> str:
    """The kernel the C entry point of ``kernel`` (one of ``KERNELS``) runs
    for this type and head width: ``"tensor"``, ``"wide"``, ``"float32"`` or
    ``"cuda_cores"`` (the same rule is written
    out in each source's ``extern "C"`` function): bfloat16 at multiples of 8
    up to 128 on the tensor cores in all three; bfloat16 at multiples of 64
    above 128 up to 512 on the wide tensor-core kernels in all three
    (``"wide"``); float32 at every
    width on the float32 kernels in all three (dK/dV and dQ above 128 on
    their wide float32 kernels); the other bfloat16 widths on the first
    CUDA-core kernels."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}: one of {KERNELS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {dtype}")
    if not head_width_supported(width):
        raise ValueError(f"flash_attention kernels take head widths that are multiples of 4 up "
                         f"to {MAX_HEAD_WIDTH}, got {width}")
    if dtype == torch.float32:
        return "float32"
    if width <= NARROW_HEAD_WIDTH and width % 8 == 0:
        return "tensor"
    if width > NARROW_HEAD_WIDTH and width % 64 == 0:
        return "wide"
    return "cuda_cores"


def flash_self_attention_ok(n: int, m: int, dim_head: int) -> bool:
    """The attention modules' gate: self-attention (``n == m``) with a head
    width the kernels take, over at least ``MIN_FLASH_SEQ_LEN`` positions
    where bfloat16 takes the tensor-core kernels and float32 the narrow
    forward at that width (multiples of 8 up to ``FLOAT32_NARROW_FWD_WIDTH``),
    else ``MIN_FLASH_SEQ_LEN_WIDE``, unless
    ``RGIE_FLASH_ATTN`` is ``"0"``. Anything else (the 77-key
    cross-attention, the shortest sequences, the VAE's 512-wide head below
    8192 positions) stays on the matmul-softmax-matmul path."""
    if FLASH_ATTN == "0" or n != m or not head_width_supported(dim_head):
        return False
    narrow = (kernel_route("fwd", torch.bfloat16, dim_head) == "tensor"
              and dim_head <= FLOAT32_NARROW_FWD_WIDTH)
    return n >= (MIN_FLASH_SEQ_LEN if narrow else MIN_FLASH_SEQ_LEN_WIDE)


# ---------------------------------------------------------------------------
# Plain PyTorch version (tiled)
# ---------------------------------------------------------------------------


def reference_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              sm_scale: float = 1.0, block_q: int = 512, block_k: int = 512
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` for ``(B, H, N, d)`` inputs: ``o = softmax(q k^T *
    sm_scale) v`` in the inputs' type and the float32 row log-sum-exp ``(B, H,
    N)``. Walks key tiles with the online softmax as the forward kernel does;
    sums in float32; P is rounded to the inputs' type before ``P v``."""
    qf, kf, vf = q.float(), k.float(), v.float()
    n, m = q.shape[2], k.shape[2]
    outs, lses = [], []
    for q0 in range(0, n, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        row_m = torch.full(qt.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
        row_l = torch.zeros_like(row_m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, m, block_k):
            s = torch.matmul(qt, kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * sm_scale
            m_new = torch.maximum(row_m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(row_m - m_new)
            row_l = row_l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(_rounded(p, q.dtype),
                                                        vf[:, :, k0:k0 + block_k])
            row_m = m_new
        outs.append(acc / row_l[..., None])
        lses.append(row_m + torch.log(row_l))
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float32 ``x`` rounded to ``dtype`` and widened again: where the kernels
    hand P and dS to the second product in the inputs' type. The identity
    (the same tensor) for float32."""
    return x.to(dtype).float()


def _row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o * do)`` in float32, ``(B, H, N)``."""
    return (o.float() * do.float()).sum(dim=-1)


def reference_flash_attention_bwd_dkv(q, k, v, do, lse, di, sm_scale: float,
                                      block_q: int = 512, block_k: int = 512):
    """``(dk, dv)`` as the dK/dV kernel computes them: per key tile, a walk
    over the query tiles with ``p = exp(s - lse)``, ``dv += p^T do``,
    ``ds = p * (do v^T - di) * sm_scale``, ``dk += ds^T q``; ``p`` and ``ds``
    enter their products rounded to the inputs' type."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dks, dvs = [], []
    for k0 in range(0, k.shape[2], block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
        for q0 in range(0, q.shape[2], block_q):
            sl = slice(q0, q0 + block_q)
            p = torch.exp(torch.matmul(qf[:, :, sl], kt.transpose(-1, -2)) * sm_scale
                          - lse[:, :, sl, None])
            dv = dv + torch.matmul(_rounded(p, q.dtype).transpose(-1, -2), dof[:, :, sl])
            dp = torch.matmul(dof[:, :, sl], vt.transpose(-1, -2))
            ds = p * (dp - di[:, :, sl, None]) * sm_scale
            dk = dk + torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2), qf[:, :, sl])
        dks.append(dk)
        dvs.append(dv)
    return torch.cat(dks, dim=2).to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype)


def reference_flash_attention_bwd_dq(q, k, v, do, lse, di, sm_scale: float,
                                     block_q: int = 512, block_k: int = 512):
    """``dq`` as the dQ kernel computes it: per query tile, a walk over the
    key tiles with ``dq += ds k``, ``ds`` rounded to the inputs' type."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dqs = []
    for q0 in range(0, q.shape[2], block_q):
        sl = slice(q0, q0 + block_q)
        dq = torch.zeros_like(qf[:, :, sl])
        for k0 in range(0, k.shape[2], block_k):
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            p = torch.exp(torch.matmul(qf[:, :, sl], kt.transpose(-1, -2)) * sm_scale
                          - lse[:, :, sl, None])
            dp = torch.matmul(dof[:, :, sl], vt.transpose(-1, -2))
            ds = p * (dp - di[:, :, sl, None]) * sm_scale
            dq = dq + torch.matmul(_rounded(ds, q.dtype), kt)
        dqs.append(dq)
    return torch.cat(dqs, dim=2).to(q.dtype)


def reference_flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float,
                                  block_q: int = 512, block_k: int = 512):
    """``(dq, dk, dv)`` from the saved output and log-sum-exp, with the
    kernels' formulas."""
    di = _row_delta(o, do)
    dk, dv = reference_flash_attention_bwd_dkv(q, k, v, do, lse, di, sm_scale, block_q, block_k)
    dq = reference_flash_attention_bwd_dq(q, k, v, do, lse, di, sm_scale, block_q, block_k)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The CUDA kernels through ctypes
# ---------------------------------------------------------------------------


def build_kernels(verbose: bool = False) -> None:
    """Compile the three kernel sources (in parallel) if they are stale."""
    build.build_libraries(KERNEL_SOURCES, verbose=verbose)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "rgie_flash_attention_fwd": [_PTR] * 5 + [_INT] * 4 + [_PTR, ctypes.c_float, _INT, _PTR],
    "rgie_flash_attention_bwd_dkv": [_PTR] * 8 + [_INT] * 4 + [_PTR, ctypes.c_float, _INT, _PTR],
    "rgie_flash_attention_bwd_dq": [_PTR] * 7 + [_INT] * 4 + [_PTR, ctypes.c_float, _INT, _PTR],
}


def _kernel(source: str, symbol: str):
    fn = getattr(build.load_library(source), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = _INT
    return fn


def load_width(dtype: torch.dtype, width: int) -> int:
    """Elements the kernels load at once from a tensor of this type and head
    width. Q, K, V and dO are read by all three kernels (the saved Q, K and V
    of a forward go on to both backward kernels), so this is the strictest
    load of the three routes: 16 bytes (4 float32; 8 bfloat16 where any
    kernel takes the ``"tensor"`` or ``"wide"`` route), or the 4 bfloat16 (8
    bytes) of the ``"cuda_cores"`` kernels for the other bfloat16 widths."""
    if (dtype == torch.bfloat16 and head_width_supported(width)
            and any(kernel_route(kn, dtype, width) in ("tensor", "wide") for kn in KERNELS)):
        return 8
    return 4


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: width axis contiguous, the other strides
    multiples of the elements one load takes (``load_width``) and the base
    16-byte aligned. A view that already is (the ``(B, N, H, d)`` projections
    seen as ``(B, H, N, d)``) is read in place; anything else is copied
    (``clone``, since ``contiguous()`` hands back a contiguous tensor as it
    is, misaligned base included)."""
    step = load_width(t.dtype, t.shape[-1])
    ok = (t.stride(-1) == 1 and all(s % step == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _empty_like_heads_last(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(B, H, N, d)`` tensor stored as ``(B, N, H, d)``, so
    that the caller's ``transpose(1, 2).reshape(B, N, H * d)`` is free."""
    b, h, n, d = t.shape
    return torch.empty((b, n, h, d), dtype=t.dtype, device=t.device).transpose(1, 2)


def _stride_array(*tensors: torch.Tensor):
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def _check_status(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {status}"
                           if status > 0 else f"{what}: shape not taken by the kernel")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES_FWD
    b, h, n, d = q.shape
    o = _empty_like_heads_last(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = _stride_array(q, k, v, o)
    status = _kernel(KERNEL_SOURCES[0], "rgie_flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, n, d,
        ctypes.addressof(strides), sm_scale, int(q.dtype == torch.bfloat16), _stream(q))
    _check_status(status, "flash_attention forward")
    LAUNCHES_FWD += 1
    return o, lse


def _launch_bwd_dkv(q, k, v, do, lse, di, sm_scale: float):
    global LAUNCHES_BWD_DKV
    b, h, n, d = q.shape
    dk, dv = _empty_like_heads_last(k), _empty_like_heads_last(v)
    strides = _stride_array(q, k, v, do, dk, dv)
    status = _kernel(KERNEL_SOURCES[1], "rgie_flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, n, d, ctypes.addressof(strides), sm_scale,
        int(q.dtype == torch.bfloat16), _stream(q))
    _check_status(status, "flash_attention backward dK/dV")
    LAUNCHES_BWD_DKV += 1
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, di, sm_scale: float):
    global LAUNCHES_BWD_DQ
    b, h, n, d = q.shape
    dq = _empty_like_heads_last(q)
    strides = _stride_array(q, k, v, do, dq)
    status = _kernel(KERNEL_SOURCES[2], "rgie_flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), b, h, n, d, ctypes.addressof(strides), sm_scale,
        int(q.dtype == torch.bfloat16), _stream(q))
    _check_status(status, "flash_attention backward dQ")
    LAUNCHES_BWD_DQ += 1
    return dq


def _check_inputs(q, k, v) -> None:
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention takes q, k, v of one shape (B, H, N, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention takes q, k, v of one type on one device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {q.dtype}")
    if not head_width_supported(q.shape[-1]):
        raise ValueError(f"flash_attention kernels take head widths that are multiples of 4 up "
                         f"to {MAX_HEAD_WIDTH}, got {q.shape[-1]}")
    if q.shape[0] * q.shape[1] > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention kernels take at most {MAX_BATCH_HEADS} (batch, head) "
                         "pairs")


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels (``use_kernel``) or through the
    plain tiled version; the residuals are the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, use_kernel):
        if use_kernel:
            q, k, v = _strided(q), _strided(k), _strided(v)
            o, lse = _launch_fwd(q, k, v, sm_scale)
        else:
            o, lse = reference_flash_attention(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.use_kernel = sm_scale, use_kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.use_kernel:
            do = _strided(do)
            di = _row_delta(o, do)
            dk, dv = _launch_bwd_dkv(q, k, v, do, lse, di, ctx.sm_scale)
            dq = _launch_bwd_dq(q, k, v, do, lse, di, ctx.sm_scale)
        else:
            dq, dk, dv = reference_flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None, None


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: float = 1.0) -> torch.Tensor:
    """The plain version with its hand-written backward, differentiable, on
    whatever device the tensors lie: what ``flash_attention`` runs for CPU
    tensors, and what a check on the card holds the kernels against."""
    return _FlashAttention.apply(q, k, v, float(sm_scale), False)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ab=None,
                    segment_ids=None, *, causal: bool = False, sm_scale: float = 1.0
                    ) -> torch.Tensor:
    """``softmax(q k^T * sm_scale) v`` for ``(B, H, N, d)`` tensors without the
    ``N x N`` scores, differentiable in q, k and v. The signature follows the
    JAX library's; a bias, segment ids or a causal mask raise (no caller in
    this package passes one). The result is ``(B, H, N, d)`` stored as ``(B,
    N, H, d)``."""
    if ab is not None or segment_ids is not None or causal:
        raise NotImplementedError("flash_attention takes no bias, segment ids or causal mask")
    _check_inputs(q, k, v)
    return _FlashAttention.apply(q, k, v, float(sm_scale), q.device.type == "cuda")


def flash_attention_with_lse(q, k, v, sm_scale: float = 1.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: ``(o, lse)``, the kernel's residual included (the
    ``save_residuals`` output of the TPU kernel, as one log-sum-exp)."""
    _check_inputs(q, k, v)
    if q.device.type == "cuda":
        return _launch_fwd(_strided(q), _strided(k), _strided(v), float(sm_scale))
    return reference_flash_attention(q, k, v, float(sm_scale))
