// Multi-level RoIAlign3D forward, one launch per align call.
//
// Replaces the TPU kernels mrcnn3d/ops/roi_align3d_pallas.py:_make_kernel
// / roi_align_3d_pallas and their level dispatch
// multi_level_roi_align_3d_pallas.  Same function as
// mrcnn3d/ops/roi_align3d.py:multi_level_roi_align_3d (the reference CUDA
// ROIAlignForward3D sample and edge rules): per roi and output bin,
// sample_num^3 trilinear samples at start + p*bin + (i + .5)*bin/sn,
// coordinates below -1 or above dim contribute 0, coordinates <= 0 clamp
// to 0, a low index >= dim-1 collapses onto the edge voxel; the bin value
// is the mean of its samples.  Each roi reads the FPN level the wrapper
// assigned to it (map_roi_levels); invalid rois write zeros.
//
// Layout: features are read as (B, D, H, W, C) storage.  The port runs
// the backbone and FPN in torch.channels_last_3d on the card, so the
// levels arrive in that storage with no copy (cuDNN runs its tensor-core
// 3-D convolutions in NDHWC anyway); a warp then reads 32 neighbouring
// channels of one corner as one contiguous row.  Output is written as
// (N, C, od, o, o), what the heads consume, through a shared-memory tile
// so the stores are contiguous too.
//
// What bounds it on the H100: counted as chip_smoke.py counts it, the
// arithmetic (8 corners x multiply-add per sample, in float32) comes
// before the bytes (the touched feature voxels plus the output): 0.47 ms
// against 0.16 ms for 2000 rois at mask geometry.  The kernel runs far
// above that bound because every output value issues sn^3 * 8 = 64
// scattered corner reads, served from L1/L2 (the windows of a level fit
// the 50 MB L2).  This first version reads device memory directly (no
// window: exact for every roi, where the TPU kernel clamps rois larger
// than its VMEM window) and keeps the interpolation unfactored; a
// separable x-then-y-then-z form would cut the reads per output 8-fold
// and is left for a later change.
//
// Built with -fmad=false: the sample coordinates round as in the plain
// PyTorch version, so floor() picks the same voxels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 4;
constexpr int kBins = 64;      // output bins per block
constexpr int kThreads = 256;

struct Levels {
  const void* ptr[kMaxLevels];
  int d[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
  float scale[kMaxLevels], scale_d[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Tap {
  int lo, hi;
  float wl, wh;
  bool in;
};

// sample coordinate lo + bin * (p + (i + .5) / sn), then the CUDA rules
__device__ __forceinline__ Tap tap(float start, float bin, int p, int i,
                                   int sn, int dim) {
  const float s = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                            static_cast<float>(sn));
  const float coord =
      __fadd_rn(start, __fmul_rn(bin, __fadd_rn(static_cast<float>(p), s)));
  Tap t;
  t.in = coord >= -1.0f && coord <= static_cast<float>(dim);
  float c = fmaxf(coord, 0.0f);
  int low = static_cast<int>(floorf(c));
  if (low >= dim - 1) {
    low = dim - 1;
    t.hi = dim - 1;
    c = static_cast<float>(low);
  } else {
    t.hi = low + 1;
  }
  t.lo = low;
  const float l = __fsub_rn(c, static_cast<float>(low));
  t.wl = __fsub_rn(1.0f, l);
  t.wh = l;
  return t;
}

// grid (rois, ceil(bins / kBins)); each thread owns (bin, channel) pairs,
// channel fastest, so a warp's corner reads are channel-contiguous
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align3d_kernel(Levels lv, const float* __restrict__ rois,
                   const int* __restrict__ levels,
                   const unsigned char* __restrict__ valid,
                   T* __restrict__ out, int channels, int out_size,
                   int out_d, int sn) {
  extern __shared__ float tile[];  // [kBins][channels + 1]
  const int n = blockIdx.x;
  const int nbins = out_d * out_size * out_size;
  const int bin0 = blockIdx.y * kBins;
  const int nb = min(kBins, nbins - bin0);
  const int ld = channels + 1;
  T* dst = out + static_cast<size_t>(n) * channels * nbins + bin0;

  if (!valid[n]) {
    for (int e = threadIdx.x; e < nb * channels; e += blockDim.x)
      store(dst + static_cast<size_t>(e / nb) * nbins + e % nb, 0.0f);
    return;
  }

  const int l = levels[n];
  const T* f = static_cast<const T*>(lv.ptr[l]);
  const int D = lv.d[l], H = lv.h[l], W = lv.w[l];
  const float sc = lv.scale[l], scd = lv.scale_d[l];
  const float* r = rois + static_cast<size_t>(n) * 7;
  const int b = static_cast<int>(r[0]);
  const float start_w = __fmul_rn(r[1], sc);
  const float start_h = __fmul_rn(r[2], sc);
  const float end_w = __fmul_rn(__fadd_rn(r[3], 1.0f), sc);
  const float end_h = __fmul_rn(__fadd_rn(r[4], 1.0f), sc);
  const float start_d = __fmul_rn(r[5], scd);
  const float end_d = __fmul_rn(__fadd_rn(r[6], 1.0f), scd);
  const float bin_w =
      __fdiv_rn(fmaxf(__fsub_rn(end_w, start_w), 0.0f), (float)out_size);
  const float bin_h =
      __fdiv_rn(fmaxf(__fsub_rn(end_h, start_h), 0.0f), (float)out_size);
  const float bin_d =
      __fdiv_rn(fmaxf(__fsub_rn(end_d, start_d), 0.0f), (float)out_d);
  const size_t plane = static_cast<size_t>(H) * W * channels;
  const T* fb = f + static_cast<size_t>(b) * D * plane;
  const float count = static_cast<float>(sn * sn * sn);

  for (int e = threadIdx.x; e < nb * channels; e += blockDim.x) {
    const int bl = e / channels;
    const int c = e - bl * channels;
    const int bin = bin0 + bl;
    const int px = bin % out_size;
    const int py = (bin / out_size) % out_size;
    const int pz = bin / (out_size * out_size);
    Tap tx[kMaxSamples], ty[kMaxSamples];
    for (int i = 0; i < sn; ++i) {
      tx[i] = tap(start_w, bin_w, px, i, sn, W);
      ty[i] = tap(start_h, bin_h, py, i, sn, H);
    }
    float acc = 0.0f;
    for (int iz = 0; iz < sn; ++iz) {
      const Tap tz = tap(start_d, bin_d, pz, iz, sn, D);
      const T* z0 = fb + static_cast<size_t>(tz.lo) * plane + c;
      const T* z1 = fb + static_cast<size_t>(tz.hi) * plane + c;
      for (int iy = 0; iy < sn; ++iy) {
        const Tap t_y = ty[iy];
        const size_t y0 = static_cast<size_t>(t_y.lo) * W * channels;
        const size_t y1 = static_cast<size_t>(t_y.hi) * W * channels;
        const float wzy00 = __fmul_rn(tz.wl, t_y.wl);
        const float wzy01 = __fmul_rn(tz.wl, t_y.wh);
        const float wzy10 = __fmul_rn(tz.wh, t_y.wl);
        const float wzy11 = __fmul_rn(tz.wh, t_y.wh);
        for (int ix = 0; ix < sn; ++ix) {
          const Tap t_x = tx[ix];
          if (!(tz.in && t_y.in && t_x.in)) continue;
          const size_t x0 = static_cast<size_t>(t_x.lo) * channels;
          const size_t x1 = static_cast<size_t>(t_x.hi) * channels;
          float v = load(z0 + y0 + x0) * __fmul_rn(wzy00, t_x.wl);
          v = __fadd_rn(v, load(z0 + y0 + x1) * __fmul_rn(wzy00, t_x.wh));
          v = __fadd_rn(v, load(z0 + y1 + x0) * __fmul_rn(wzy01, t_x.wl));
          v = __fadd_rn(v, load(z0 + y1 + x1) * __fmul_rn(wzy01, t_x.wh));
          v = __fadd_rn(v, load(z1 + y0 + x0) * __fmul_rn(wzy10, t_x.wl));
          v = __fadd_rn(v, load(z1 + y0 + x1) * __fmul_rn(wzy10, t_x.wh));
          v = __fadd_rn(v, load(z1 + y1 + x0) * __fmul_rn(wzy11, t_x.wl));
          v = __fadd_rn(v, load(z1 + y1 + x1) * __fmul_rn(wzy11, t_x.wh));
          acc = __fadd_rn(acc, v);
        }
      }
    }
    tile[bl * ld + c] = __fdiv_rn(acc, count);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nb * channels; e += blockDim.x) {
    const int c = e / nb;
    const int bl = e - c * nb;
    store(dst + static_cast<size_t>(c) * nbins + bl, tile[bl * ld + c]);
  }
}

template <typename T>
int launch(const Levels& lv, const void* rois, const void* levels,
           const void* valid, void* out, int n, int channels, int out_size,
           int out_d, int sn, cudaStream_t s) {
  const int nbins = out_d * out_size * out_size;
  const size_t smem = static_cast<size_t>(kBins) * (channels + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        roi_align3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n, (nbins + kBins - 1) / kBins);
  roi_align3d_kernel<T><<<grid, kThreads, smem, s>>>(
      lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out),
      channels, out_size, out_d, sn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// level_ptrs[L]: (B, D, H, W, C) storage of each level; level_dims[L*3]:
// (D, H, W); level_scales[L*2]: (1/stride_xy, 1/stride_d).  rois (n, 7) f32
// [b, x1, y1, x2, y2, z1, z2]; levels (n,) i32; valid (n,) u8.
// dtype 0 = float32, 1 = bfloat16.  out (n, C, od, o, o) of that dtype.
extern "C" int mrcnn3d_roi_align3d(const long long* level_ptrs,
                                   const int* level_dims,
                                   const float* level_scales, int num_levels,
                                   int dtype, int channels, const void* rois,
                                   const void* levels, const void* valid,
                                   void* out, int n, int out_size, int out_d,
                                   int sample_num, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || sample_num < 1 ||
      sample_num > kMaxSamples || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = reinterpret_cast<const void*>(level_ptrs[i]);
    lv.d[i] = level_dims[3 * i];
    lv.h[i] = level_dims[3 * i + 1];
    lv.w[i] = level_dims[3 * i + 2];
    lv.scale[i] = level_scales[2 * i];
    lv.scale_d[i] = level_scales[2 * i + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(lv, rois, levels, valid, out, n, channels, out_size,
                         out_d, sample_num, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(lv, rois, levels, valid, out, n, channels,
                                 out_size, out_d, sample_num, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
