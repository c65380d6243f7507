// Kernel K1: the fused pointwise filter prefix and the contrast after it, on
// a (B, H, W, 3) float32 NHWC batch with one parameter set:
//   exposure clip(x 2^p); RGB -> HSV, S max(p, 0), HSV -> RGB, clip; the
//   shared 8-knot tone curve, clip; the per-channel 8-knot color curves,
//   clip; then contrast clip((x - mean) max(c, 0) + mean) around the mean of
//   the ITU-601 gray image of the prefix's output.
//
// Replaces the TPU kernel `_prefix_kernel` (rgie_tpu/ops/pallas/
// pointwise_chain.py, `pl.pallas_call` at :129 under `fused_pointwise_chain`)
// and the contrast pass that the JAX package runs after it (`:142-146`).
//
// Bound on this card: memory. The function reads 12 bytes a pixel and writes
// 12 (0.030 ms for a (4, 1024, 1024, 3) batch at 3.35 TB/s) against some 60
// float32 operations a pixel. The contrast needs the mean over the whole
// image before any pixel can be written, so:
//
// - pass 1 (`k1_gray_partials`) reads the image, applies the prefix in
//   registers and writes only one gray partial sum per block: no image;
// - pass 2 (`k1_contrast`) sums its image's partials in one fixed order
//   (every block the same order, so every block the same mean, and the same
//   from run to run: no atomics), reads the image again, recomputes the
//   prefix and writes the result.
//
// 1.5 image sizes of traffic (the Triton design before it: 4, through an
// intermediate image), no intermediate buffer. A lane takes groups of 4
// pixels, a warp 128 neighbouring pixels a group: the warp reads them as
// three fully used rows of 16-byte loads, all groups' at once, and turns
// them around through shared memory (`to_lanes`); pass 2 writes the same
// way. (Each lane reading its own 4 pixels as three 16-byte loads 48 bytes
// apart ran at 1.8 TB/s, no faster without the arithmetic.) An image whose
// base is not 16-byte aligned, and the last pixels of an image that do not
// fill a warp's share, are read and written one float at a time. Both
// passes run on the caller's stream from one C entry point, which also reads
// the parameters where they lie (the `FilterParams` tensors' pointers and
// strides): the host packs nothing.
//
// The arithmetic follows the JAX kernel: full-precision division (no
// `--use_fast_math`); the hue's floor-mod written out (exact for the hues it
// selects, |q| <= 1); the clips where the JAX kernel has them. A curve's
// eight knots cost one table read (see `curve`), not eight clipped
// multiply-adds, and the sector's colours are selects, not branches.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (`python -m
// rgie_tpu_torch.cli.kernel_variants k1`): 0.076 ms on the device for a
// (4, 1024, 1024, 3) batch, 0.023 ms for one image; the passes' copies
// alone take 0.059 ms (2.5 TB/s), so the arithmetic done twice (two
// full-precision divisions and six curves a pixel and pass) is what is left.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rgie_k1 {

constexpr int kThreads = 256;
constexpr int kGroups = 2;                              // 4-pixel groups a thread
constexpr int kPixels = kThreads * kGroups * 4;         // pixels a block: 2048
constexpr int kBlocksPerSM = 4;                         // at most 64 registers a thread
constexpr float kGrayR = 0.299f, kGrayG = 0.587f, kGrayB = 0.114f;   // ITU-601

// Where the parameters lie: exposure, saturation and contrast are scalars;
// tone (8, 1) and color (8, 3) are read through their strides in elements.
struct ParamPointers {
  const float* exposure;
  const float* saturation;
  const float* tone;
  long long tone_stride;
  const float* color;
  long long color_knot_stride, color_channel_stride;
  const float* contrast;
};

// The parameters in shared memory (16-byte aligned): for each curve (tone;
// color of r, g, b) the pairs (C_k, w_k), k = 0..7, of its running sums and
// weights (see `curve`); then 2^exposure, max(saturation, 0), max(contrast, 0).
constexpr int kExposure = 64, kSaturation = 65, kContrast = 66;
constexpr int kParams = 67;

__device__ __forceinline__ void load_params(float* p, const ParamPointers& pp) {
  const int i = threadIdx.x;
  if (i < 4) {
    // Curve i: C_k = sum_{j<k} w_j / 8, summed in the order of the JAX
    // kernel's loop (w_j / 8 is exact).
    float* table = p + 16 * i;
    float total = 0.f;
    for (int j = 0; j < 8; ++j) {
      const float w = i == 0 ? pp.tone[j * pp.tone_stride]
                             : pp.color[j * pp.color_knot_stride +
                                        (i - 1) * pp.color_channel_stride];
      table[2 * j] = total;
      table[2 * j + 1] = w;
      total += 0.125f * w;
    }
  }
  if (i == 4) p[kExposure] = exp2f(*pp.exposure);
  if (i == 5) {
    const float s = *pp.saturation;
    p[kSaturation] = s < 0.f ? 0.f : s;
  }
  if (i == 6) {
    const float c = *pp.contrast;
    p[kContrast] = c < 0.f ? 0.f : c;
  }
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// The 8-knot curve of the JAX kernel: the sum, knot by knot in order, of
// clip(v - i/8, 0, 1/8) w_i, then clipped. For v in [0, 1] and k =
// min(floor(8 v), 7), the knots below k add w_i / 8 exactly, knot k adds
// (v - k/8) w_k (the difference is exact) and the knots above add zeros, so
// the sum is C_k + (v - k/8) w_k with the running sum C_k from the table,
// (C_k, w_k) one 8-byte read.
__device__ __forceinline__ float curve(float v, const float* table) {
  const int k = min((int)(v * 8.f), 7);
  const float2 cw = reinterpret_cast<const float2*>(table)[k];
  return fmaxf(fminf(cw.x + (v - k * 0.125f) * cw.y, 1.f), 0.f);
}

// The prefix on one pixel, in place.
__device__ __forceinline__ void prefix(float& r, float& g, float& b, const float* p) {
  r = clip01(r * p[kExposure]);
  g = clip01(g * p[kExposure]);
  b = clip01(b * p[kExposure]);

  // Saturation through HSV, the hue in sixths, without a branch (the
  // neighbouring pixels of a warp fall in different sectors). Only the hue
  // of the channel at the maximum is computed: the JAX kernel computes all
  // three and selects the same one. With r at the maximum |q| <= 1, so the
  // floor-mod q % 6 is q, or q + 6 where q < 0, as `jnp.remainder` has it.
  const float cmax = fmaxf(fmaxf(r, g), b);
  const float cmin = fminf(fminf(r, g), b);
  const float delta = cmax - cmin;
  const float safe = delta == 0.f ? 1.f : delta;
  const bool is_r = r >= g && r >= b;   // the first channel at the maximum wins
  const bool is_g = !is_r && g >= b;
  const float q = (is_r ? g - b : is_g ? b - r : r - g) / safe;
  const float hue = is_r ? (q < 0.f ? q + 6.f : q) : q + (is_g ? 2.f : 4.f);
  const float h6 = delta == 0.f ? 0.f : hue;
  const float s = cmax == 0.f ? 0.f : delta / cmax;
  const float c = cmax * (s * p[kSaturation]);
  const float x = c * (1.f - fabsf(h6 - 2.f * floorf(h6 * 0.5f) - 1.f));   // h6 >= 0
  const float m = cmax - c;
  // The JAX kernel's `pick` over sector = floor(h6) % 6 (h6 in [0, 6]): r is
  // c in sectors 0 and 5, x in 1 and 4, else 0; g c in 1, 2, x in 0, 3; b c
  // in 3, 4, x in 2, 5. One bit a sector.
  const int whole = (int)h6;
  const int bit = 1 << (whole == 6 ? 0 : whole);
  const float nr = bit & 0x21 ? c : bit & 0x12 ? x : 0.f;
  const float ng = bit & 0x06 ? c : bit & 0x09 ? x : 0.f;
  const float nb = bit & 0x18 ? c : bit & 0x24 ? x : 0.f;
  r = clip01(nr + m);
  g = clip01(ng + m);
  b = clip01(nb + m);

  r = curve(r, p);
  g = curve(g, p);
  b = curve(b, p);
  r = curve(r, p + 16);
  g = curve(g, p + 32);
  b = curve(b, p + 48);
}

// The sum of `v` over the block, the same in every thread, in a fixed order.
// `scratch` may be used again when it returns.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// The pixels of a group that this lane reads itself, 12 floats (zeros past
// hw): where the warp's 128 pixels do not all lie in the image, or the
// image's base is not 16-byte aligned.
__device__ __forceinline__ void load_pixels(const float* img, int p0, int hw, float (&px)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) px[i] = p0 + i / 3 < hw ? __ldg(img + 3LL * p0 + i) : 0.f;
}

// First pixel of the warp's share of group g of block bx: 128 consecutive
// pixels, 4 a lane.
__device__ __forceinline__ int warp_first_pixel(int bx, int g) {
  return bx * kPixels + (g * kThreads + (threadIdx.x & ~31)) * 4;
}

// A warp's 128 pixels are 96 float4: lane l reads float4s l, l + 32 and
// l + 64 (three fully used 512-byte rows), and `stage` (96 float4 of the
// warp's own) turns them around so that the lane holds float4s 3 l .. 3 l + 2,
// its own 4 pixels (a quarter-warp's 16-byte reads there fall in 8 distinct
// bank groups: 48 l mod 128).
__device__ __forceinline__ void to_lanes(const float4 (&rows)[3], float4* stage,
                                         float (&px)[12]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 3; ++j) stage[lane + 32 * j] = rows[j];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float4 f = stage[3 * lane + j];
    px[4 * j] = f.x;
    px[4 * j + 1] = f.y;
    px[4 * j + 2] = f.z;
    px[4 * j + 3] = f.w;
  }
  __syncwarp();
}

// Every group's rows, read before any arithmetic so that all of them are on
// their way at once; `whole[g]`: the warp's share of group g is read so.
__device__ __forceinline__ void load_rows(const float* img, int bx, int hw, bool aligned,
                                          float4 (&rows)[kGroups][3], bool (&whole)[kGroups]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int first = warp_first_pixel(bx, g);
    whole[g] = aligned && first + 128 <= hw;
    if (whole[g]) {
      const float4* src = reinterpret_cast<const float4*>(img + 3LL * first);
#pragma unroll
      for (int j = 0; j < 3; ++j) rows[g][j] = __ldg(src + lane + 32 * j);
    }
  }
}

// Pass 1 for block bx of image by: the gray sum of its pixels after the
// prefix, into partials[by * blocks + bx]. Pixels [bx * kPixels, + kPixels)
// in kGroups groups of 4 a lane.
__device__ __forceinline__ void gray_partial(const float* __restrict__ image,
                                             float* __restrict__ partials, int hw, int blocks,
                                             int bx, int by, const float* p, float* scratch,
                                             float4* stage) {
  const float* img = image + (long long)by * hw * 3;
  float4 rows[kGroups][3];
  bool whole[kGroups];
  load_rows(img, bx, hw, (reinterpret_cast<uintptr_t>(img) & 15) == 0, rows, whole);
  float gray = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int first = warp_first_pixel(bx, g);
    if (first >= hw) break;   // the same in the whole warp
    const int p0 = first + 4 * (threadIdx.x & 31);
    float px[12];
    if (whole[g]) {
      to_lanes(rows[g], stage, px);
    } else {
      load_pixels(img, p0, hw, px);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p0 + i < hw) {
        prefix(px[3 * i], px[3 * i + 1], px[3 * i + 2], p);
        gray += kGrayR * px[3 * i] + kGrayG * px[3 * i + 1] + kGrayB * px[3 * i + 2];
      }
    }
  }
  gray = block_sum(gray, scratch);
  if (threadIdx.x == 0) partials[(long long)by * blocks + bx] = gray;
}

// Pass 2 for block bx of image by: the image's mean from its partials (one
// fixed order, the same in every block), then the prefix again and the
// contrast, written out the way the pixels came in.
__device__ __forceinline__ void contrast_block(const float* __restrict__ image,
                                               float* __restrict__ out,
                                               const float* __restrict__ partials, int hw,
                                               int blocks, int bx, int by, const float* p,
                                               float* scratch, float4* stage) {
  const long long base = (long long)by * hw * 3;
  const float* img = image + base;
  float* dst = out + base;
  float4 rows[kGroups][3];
  bool whole[kGroups];
  load_rows(img, bx, hw,
            ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0,
            rows, whole);
  const float* part = partials + (long long)by * blocks;
  float sum = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) sum += __ldcg(part + i);
  const float mean = block_sum(sum, scratch) / (float)hw;
  const float contrast = p[kContrast];

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int first = warp_first_pixel(bx, g);
    if (first >= hw) break;   // the same in the whole warp
    const int p0 = first + 4 * lane;
    float px[12];
    if (whole[g]) {
      to_lanes(rows[g], stage, px);
    } else {
      load_pixels(img, p0, hw, px);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      prefix(px[3 * i], px[3 * i + 1], px[3 * i + 2], p);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        px[3 * i + ch] = clip01((px[3 * i + ch] - mean) * contrast + mean);
      }
    }
    if (whole[g]) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        stage[3 * lane + j] = make_float4(px[4 * j], px[4 * j + 1], px[4 * j + 2], px[4 * j + 3]);
      }
      __syncwarp();
      float4* o = reinterpret_cast<float4*>(dst + 3LL * first);
#pragma unroll
      for (int j = 0; j < 3; ++j) o[lane + 32 * j] = stage[lane + 32 * j];
      __syncwarp();
    } else {
      for (int i = 0; i < 12 && p0 + i / 3 < hw; ++i) dst[3LL * p0 + i] = px[i];
    }
  }
}

// grid (blocks, batch): one block of kPixels pixels each.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
k1_gray_partials(const float* __restrict__ image, float* __restrict__ partials, int hw,
                 ParamPointers pp) {
  __shared__ __align__(16) float p[kParams];
  __shared__ float scratch[kThreads / 32];
  __shared__ float4 stage[kThreads * 3];
  load_params(p, pp);
  __syncthreads();
  gray_partial(image, partials, hw, gridDim.x, blockIdx.x, blockIdx.y, p, scratch,
               stage + 3 * (threadIdx.x & ~31));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
k1_contrast(const float* __restrict__ image, float* __restrict__ out,
            const float* __restrict__ partials, int hw, ParamPointers pp) {
  __shared__ __align__(16) float p[kParams];
  __shared__ float scratch[kThreads / 32];
  __shared__ float4 stage[kThreads * 3];
  load_params(p, pp);
  __syncthreads();
  contrast_block(image, out, partials, hw, gridDim.x, blockIdx.x, blockIdx.y, p, scratch,
                 stage + 3 * (threadIdx.x & ~31));
}

}  // namespace rgie_k1

// image, out: (batch, hw, 3) float32, contiguous; partials: `n_partials`
// float32 of scratch, at least batch * ceil(hw / 2048). The parameters are
// read on the device where the pointers say, tone (8, 1) with its knot
// stride and color (8, 3) with its knot and channel strides, in elements.
// Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success), or -1 for a shape the kernel does not take.
extern "C" int rgie_pointwise_chain(const float* image, float* out, float* partials,
                                    long long n_partials, int batch, int hw,
                                    const float* exposure, const float* saturation,
                                    const float* tone, long long tone_stride, const float* color,
                                    long long color_knot_stride, long long color_channel_stride,
                                    const float* contrast, void* stream) {
  using namespace rgie_k1;
  if (batch <= 0 || batch > 65535 || hw <= 0 || (long long)hw * 3 >= (1LL << 31)) return -1;
  const int blocks = (hw + kPixels - 1) / kPixels;
  if (n_partials < (long long)batch * blocks) return -1;
  const ParamPointers pp{exposure, saturation, tone, tone_stride, color, color_knot_stride,
                         color_channel_stride, contrast};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks, batch);
  k1_gray_partials<<<grid, kThreads, 0, s>>>(image, partials, hw, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_contrast<<<grid, kThreads, 0, s>>>(image, out, partials, hw, pp);
  return (int)cudaGetLastError();
}
