"""Time variants of the flash-attention kernels against the package's own,
inside one process on one card, to see what bounds a kernel.

    python -m rgie_tpu_torch.cli.kernel_variants

A variant is the package's source with a few lines replaced (``VARIANTS``
below). The script copies ``rgie_tpu_torch/csrc/`` into ``build/variants/``
(ignored by git), applies each variant's edits to the copy, compiles it with
the package's ``nvcc`` flags, loads it with ``ctypes`` and times it in
alternation with the package's kernel on the same tensors (CUDA events,
median of 7). Nothing in the package is touched, and the package never
launches a variant. An edit names the exact lines it replaces; when the
source has changed under it, the script raises and says which edit no longer
applies.

The variants:

- ``dq_copies_only``, ``wide_copies_only``: the multiplying warpgroups only
  meet the barriers, so the time is that of the ``cp.async`` ring alone
  (printed with the bytes it brings from the L2 cache). Their results are
  not compared.
- ``dq_without_ex2``: the exponential of every score replaced by its
  argument: what the special-function unit costs. Not compared.
- ``dq_64_key_tiles``: 64-key tiles at head widths up to 64 (the package
  takes 128). Compared: equal to the package's result.
- ``dq_free_warpgroups``: the two multiplying warpgroups meet the copying one
  on named barriers of their own (tile arrived: 1 and 2; tile released: 3
  and 4) and no longer each other. Compared: equal to the package's result.

Prints the card's name and power limit first. Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import torch

from rgie_tpu_torch.device import resolve_device
from rgie_tpu_torch.ops.kernels import build
from rgie_tpu_torch.ops.kernels import flash_attention as FA

VARIANT_DIR = build.BUILD_DIR.parent / "variants"

_DQ, _FWD = "flash_attention_bwd_dq", "flash_attention_fwd"

_NAMED_BARRIERS = """
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dq_tc_kernel("""

#: name -> (source, [(lines to replace, replacement), ...])
VARIANTS = {
    "dq_copies_only": (_DQ, [(
        """  registers_inc<kTcRegisters>();

  // Per thread: rows lane / 4 and lane / 4 + 8 of its warp's 16-row band.
  const float scale2""",
        """  registers_inc<kTcRegisters>();
  if (n > 0) {
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) __syncthreads();
    return;
  }

  // Per thread: rows lane / 4 and lane / 4 + 8 of its warp's 16-row band.
  const float scale2""")]),
    "dq_without_ex2": (_DQ, [(
        "const float p = fast_exp2(fmaf(s[4 * j + i], scale2, neg_lse2[i >> 1]));",
        "const float p = fmaf(s[4 * j + i], scale2, neg_lse2[i >> 1]);")]),
    "dq_64_key_tiles": (_DQ, [(
        "constexpr int kDqKeys = NATOM == 1 ? 128 : 64;", "constexpr int kDqKeys = 64;")]),
    "dq_free_warpgroups": (_DQ, [
        ("""template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dq_tc_kernel(""", _NAMED_BARRIERS),
        ("""    load_kv(0);
    load_kv(1);
    cp_async_wait_and_publish<1>();   // Q, dO and tile 0
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      cp_async_wait_and_publish<0>();   // tile kt + 1
      __syncthreads();
      load_kv(kt + 2);
    }
    return;""",
         """    load_kv(0);
    load_kv(1);
    load_kv(2);
    cp_async_wait_and_publish<2>();   // Q, dO and tile 0
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      if (kt >= 1) {   // both warpgroups released tile kt - 1: its stage takes tile kt + 2
        named_sync(3, 256);
        named_sync(4, 256);
        load_kv(kt + 2);
      }
      cp_async_wait_and_publish<1>();   // tile kt + 1
      named_arrive(1, 256);
      named_arrive(2, 256);
    }
    return;"""),
        ("""    const uint32_t next = KVs + ((kt + 1) % kDqStages) * kStageBytes;
    __syncthreads();""",
         """    const uint32_t next = KVs + ((kt + 1) % kDqStages) * kStageBytes;
    named_sync(1 + wg, 256);"""),
        ("""    for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks) pack_fragment(dsa[ks], dp, ks);
  }""",
         """    for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
    if (kt + 2 < n_tiles) named_arrive(3 + wg, 256);
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks) pack_fragment(dsa[ks], dp, ks);
  }""")]),
    "wide_copies_only": (_FWD, [(
        """  float s[kWideKeys / 2];
  uint32_t pa[kWideKeys / 16][4];
""",
        """  float s[kWideKeys / 2];
  uint32_t pa[kWideKeys / 16][4];
  if (n > 0) {
    for (int item = 0; item < 2 * n_tiles; ++item) __syncthreads();
    return;
  }
""")]),
}


def build_variant(name: str):
    """Compile variant ``name`` from a fresh copy of the sources and return
    its C entry point; prints the compiler's resource lines for the
    tensor-core kernels."""
    source, edits = VARIANTS[name]
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    for path in build.CSRC_DIR.iterdir():
        shutil.copy(path, VARIANT_DIR)
    text = (VARIANT_DIR / f"{source}.cu").read_text()
    for number, (old, new) in enumerate(edits):
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: edit {number} no longer applies to {source}.cu")
        text = text.replace(old, new)
    (VARIANT_DIR / f"{name}.cu").write_text(text)
    lib = VARIANT_DIR / f"lib{name}.so"
    done = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           str(VARIANT_DIR / f"{name}.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{done.stdout}{done.stderr}")
    lines = (done.stdout + done.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and ("_tc_kernel" in line or "_wide_kernel" in line):
            print(f"  {name}: {line.split('for ')[-1][:48]}: {lines[i + 1].strip()}")
        if "serializ" in line:
            print(f"  {name}: {line}")
    symbol = "rgie_" + source
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = FA._ARGTYPES[symbol], ctypes.c_int
    return fn


def launch_dq(fn, q, k, v, do, lse, di, scale):
    b, h, n, d = q.shape
    dq = FA._empty_like_heads_last(q)
    strides = FA._stride_array(q, k, v, do, dq)
    FA._check_status(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        di.data_ptr(), dq.data_ptr(), b, h, n, d, ctypes.addressof(strides), scale,
                        1, FA._stream(q)), "variant of backward dQ")
    return dq


def launch_fwd(fn, q, k, v, scale):
    b, h, n, d = q.shape
    o = FA._empty_like_heads_last(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = FA._stride_array(q, k, v, o)
    FA._check_status(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b,
                        h, n, d, ctypes.addressof(strides), scale, 1, FA._stream(q)),
                     "variant of forward")
    return o


def time_group(fns, reps=7):
    """Median milliseconds of each ``fn()``, timed with CUDA events in
    alternation after one warm-up round."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def make(shape, seed, device):
    b, h, n, d = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
            .to(device).to(torch.bfloat16).transpose(1, 2) for _ in range(4)]


def main():
    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    FA.build_kernels()
    fns = {name: build_variant(name) for name in VARIANTS}

    # The variants that keep the arithmetic give the package's result.
    for shape in [(1, 2, 100, 64), (1, 2, 300, 64), (1, 2, 520, 72), (1, 2, 2100, 128),
                  (1, 5, 9000, 64)]:
        q, k, v, do = make(shape, 3, device)
        scale = shape[3] ** -0.5
        o, lse = FA.flash_attention_with_lse(q, k, v, scale)
        di = FA._row_delta(o, do)
        expect = FA._launch_bwd_dq(q, k, v, do, lse, di, scale)
        for name in ("dq_64_key_tiles", "dq_free_warpgroups"):
            got = launch_dq(fns[name], q, k, v, do, lse, di, scale)
            torch.cuda.synchronize()
            if not torch.equal(got, expect):
                raise AssertionError(f"variant {name} differs from the kernel at {shape}")
    print("dq_64_key_tiles and dq_free_warpgroups equal the package's dQ at 5 shapes")

    for shape in [(2, 5, 16384, 64), (1, 5, 16384, 64), (1, 2, 16384, 128)]:
        q, k, v, do = make(shape, 3, device)
        scale = shape[3] ** -0.5
        o, lse = FA.flash_attention_with_lse(q, k, v, scale)
        di = FA._row_delta(o, do)
        names = [name for name in VARIANTS if name.startswith("dq_")]
        ms = time_group([lambda: FA._launch_bwd_dq(q, k, v, do, lse, di, scale)]
                        + [lambda name=name: launch_dq(fns[name], q, k, v, do, lse, di, scale)
                           for name in names])
        b, h, n, d = shape
        keys = 128 if d <= 64 else 64
        atoms = 1 if d <= 64 else 2
        # Every block of 128 query rows brings every K and V tile from L2.
        gb = b * h * -(-n // 128) * -(-n // keys) * 2 * atoms * keys * 128 / 1e9
        print(f"dQ {shape} bfloat16: package {ms[0]:.3f} ms; "
              + "; ".join(f"{name} {t:.3f}" for name, t in zip(names, ms[1:]))
              + f" (the ring brings {gb:.2f} GB from L2: "
              f"{gb / ms[1 + names.index('dq_copies_only')]:.2f} TB/s alone)")

    for shape in [(1, 1, 16384, 512), (1, 2, 16384, 256)]:
        q, k, v, _ = make(shape, 4, device)
        scale = shape[3] ** -0.5
        ms = time_group([lambda: FA._launch_fwd(q, k, v, scale),
                         lambda: launch_fwd(fns["wide_copies_only"], q, k, v, scale)])
        b, h, n, d = shape
        atoms = 4 if d <= 256 else 8
        # Every block of 64 query rows brings every K and V tile from L2.
        gb = b * h * -(-n // 64) * -(-n // 32) * 2 * atoms * 32 * 128 / 1e9
        print(f"wide forward {shape} bfloat16: package {ms[0]:.3f} ms; wide_copies_only "
              f"{ms[1]:.3f} (the ring brings {gb:.2f} GB from L2: {gb / ms[1]:.2f} TB/s alone)")


if __name__ == "__main__":
    main()
