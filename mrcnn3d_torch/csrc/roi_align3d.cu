// Multi-level RoIAlign3D forward: two kernel launches per align call.
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
// Layout: features are read as (B, D, H, W, C) storage (the port runs the
// backbone and FPN in channels_last_3d, so the levels arrive so at no
// copy); one voxel is a contiguous row of C channels.  Output is
// (N, C, od, o, o), what the heads consume.
//
// Design: one block of 128 threads per (roi, 32 channels), walking the
// roi's od output depth planes in turn.
//   * Tables once per roi.  The prologue computes the roi's o*sn x and y
//     taps into shared memory (an out-of-range tap gets weights 0, so the
//     contraction has no branch) and, a lane per depth plane, folds the
//     sn z samples of each plane into z planes with summed weights.  The
//     coordinates use round-to-nearest intrinsics, so floor() picks the
//     voxels the plain version picks on the CPU (roi_align3d_taps below
//     exposes them to the card tests).
//   * Window path.  The rows y0..y1 x columns x0..x1 that the in-range
//     taps touch are the roi's window on its level.  The window of every
//     z plane the roi needs is staged into shared memory with 16-byte
//     cp.async, through a ring of up to 8 buffers that runs across depth
//     planes, so later planes stream in while this one is contracted and
//     stored.  The trilinear sum is separable, because the in-range mask
//     and the weights are per-axis products:
//         X[r][px] += wz(plane) * sum_ix (wxl V[r][xlo] + wxh V[r][xhi])
//     over the depth plane's z planes, then
//         out[py][px] = sum_iy (wyl X[ylo][px] + wyh X[yhi][px]) / sn^3.
//     A voxel of a staged window is read from device memory once per
//     depth plane that needs it.  A thread owns 16 bytes of channels
//     (8 bf16 or 4 f32), so shared-memory reads are 16-byte vectors.  The
//     weights are float32 (the float32 output holds 1e-4 against the
//     plain version), so the products run on the CUDA cores, not the
//     tensor cores.  An output tile in shared memory turns the
//     (py, px, channel) results into (channel, py, px) runs, so the
//     global stores are contiguous.
//   * Direct path.  A roi whose window does not fit the block's shared
//     memory (a roi thin and wide on a fine level, or one much larger
//     than its level) goes on a list in device memory.  A second,
//     persistent kernel takes its (depth plane, channel block) items from
//     the list and reads every tap from L1/L2 directly, with the same
//     weights: exact for every roi, and a few large rois spread over
//     every SM.  The choice depends only on the roi's x/y window; the
//     roi is counted once in path_rois[0] (window) or [1] (direct).
//   * Neither path runs for an invalid roi: its blocks write zeros.
//
// What bounds it on the H100: counted as chip_smoke.py counts it (each
// touched voxel read once, the output written once; the operations of
// the separable form over the touched window), the bytes come first at
// the main path's shapes.  The kernel runs well above that bound, and
// per-block timestamps put the time in the shared-memory pipe: per
// output group a block issues about ten 16-byte shared loads (taps, X
// rows, the X read-modify-write per z plane) and eight 2-byte tile
// stores and loads, with 16 warps on an SM (the window budget allows
// four blocks).  Removing any one phase saves little; fewer
// shared-memory instructions per output is the next step.  A separable
// form by itself does not cut the reads per output: each (z, y) sample
// row belongs to one output bin, so separable lerps save multiplies, and
// reads fall only because the window is staged once and reused.
//
// Built with multiply-add contraction (no -fmad=false): only the
// interpolation sums contract; the coordinate arithmetic is all explicit
// _rn intrinsics, which nvcc never fuses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 4;
constexpr int kMaxTaps = 64;  // out_size * sample_num per axis
constexpr int kMaxPlanes = 2 * kMaxSamples;
constexpr int kMaxOutD = 32;  // output depth planes
constexpr int kMaxInFlight = 8;  // staged planes in flight per block
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 4;
constexpr int kChannelBlock = 32;

struct Levels {
  const void* ptr[kMaxLevels];
  int d[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
  float scale[kMaxLevels], scale_d[kMaxLevels];
};

struct Tap {
  int lo, hi;
  float wl, wh;
  int in;
};

// a tap as the contraction reads it: one 16-byte shared-memory load, and
// an out-of-range tap has weights 0 (and voxels inside the window)
struct __align__(16) Lerp {
  int lo, hi;
  float wl, wh;
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

// the roi's frame on its level: batch, level dims, start and bin per axis
struct Frame {
  int b, D, H, W;
  float sx, sy, sz, bx, by, bz;
};

__device__ __forceinline__ Frame roi_frame(const Levels& lv, const float* r,
                                           int l, int out_size, int out_d) {
  // r: [b, x1, y1, x2, y2, z1, z2]
  Frame f;
  const float sc = lv.scale[l], scd = lv.scale_d[l];
  f.b = static_cast<int>(r[0]);
  f.D = lv.d[l];
  f.H = lv.h[l];
  f.W = lv.w[l];
  f.sx = __fmul_rn(r[1], sc);
  f.sy = __fmul_rn(r[2], sc);
  f.sz = __fmul_rn(r[5], scd);
  const float ex = __fmul_rn(__fadd_rn(r[3], 1.0f), sc);
  const float ey = __fmul_rn(__fadd_rn(r[4], 1.0f), sc);
  const float ez = __fmul_rn(__fadd_rn(r[6], 1.0f), scd);
  f.bx = __fdiv_rn(fmaxf(__fsub_rn(ex, f.sx), 0.0f), (float)out_size);
  f.by = __fdiv_rn(fmaxf(__fsub_rn(ey, f.sy), 0.0f), (float)out_size);
  f.bz = __fdiv_rn(fmaxf(__fsub_rn(ez, f.sz), 0.0f), (float)out_d);
  return f;
}

// 16 bytes of channels as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const void* p, float* v) {
    const float4 a = *static_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const void* p, float* v) {
    const uint4 a = *static_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void to_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void to_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (< kMaxPlanes) groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// odd pitch of an output tile row (one channel): conflict-free tile writes
__host__ __device__ __forceinline__ int tile_pitch(int out_size) {
  return out_size * out_size | 1;
}

// channels of one block: all of them up to kChannelBlock, else
// kChannelBlock (the wrapper checks that they divide the channels)
__host__ __device__ __forceinline__ int channel_block(int channels) {
  return channels < kChannelBlock ? channels : kChannelBlock;
}

// Bytes of shared memory the window path needs at least for an nx x ny
// window of cb channels: X (ny rows x o columns x cb, f32), the output
// tile of one depth plane, and one staged plane.  Spare space holds more
// planes in flight.
__device__ __forceinline__ size_t window_bytes(int nx, int ny, int cb,
                                               int out_size, int elt) {
  return static_cast<size_t>(ny) * out_size * cb * 4 +
         static_cast<size_t>(cb) * tile_pitch(out_size) * elt +
         static_cast<size_t>(nx) * ny * cb * elt;
}

// One roi's tables, in shared memory: its x and y taps, the z planes of
// every depth plane, and the in-range span of the x and y taps.
struct RoiTables {
  Lerp tx[kMaxTaps], ty[kMaxTaps];
  // the z planes of every depth plane pz, in pz order: item j is plane
  // plane[j] with weight w[j]; pz owns items [item0[pz], item0[pz + 1])
  int plane[kMaxOutD * kMaxPlanes];
  float w[kMaxOutD * kMaxPlanes];
  int item0[kMaxOutD + 1];
  int span[4];  // x0, x1, y0, y1
};

// Fills the tables of the roi with frame f: warp 0 the x taps, warp 1 the
// y taps (each with its span), warp 2 the z planes, a lane per depth
// plane.  Ends with __syncthreads.
__device__ void roi_tables(RoiTables& tb, const Frame& f, int o, int out_d,
                           int sn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntap = o * sn;
  if (warp < 2) {
    const bool is_y = warp == 1;
    Lerp* lerps = is_y ? tb.ty : tb.tx;
    Tap a[kMaxTaps / 32];
    int first = INT_MAX, last = -1;
#pragma unroll
    for (int i = 0; i < kMaxTaps / 32; ++i) {
      const int k = lane + 32 * i;
      if (k >= ntap) break;
      a[i] = is_y ? tap(f.sy, f.by, k / sn, k % sn, sn, f.H)
                  : tap(f.sx, f.bx, k / sn, k % sn, sn, f.W);
      if (a[i].in) {
        first = min(first, a[i].lo);
        last = max(last, a[i].hi);
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    const int inside = first == INT_MAX ? 0 : first;
#pragma unroll
    for (int i = 0; i < kMaxTaps / 32; ++i) {
      const int k = lane + 32 * i;
      if (k >= ntap) break;
      lerps[k] = a[i].in ? Lerp{a[i].lo, a[i].hi, a[i].wl, a[i].wh}
                         : Lerp{inside, inside, 0.0f, 0.0f};
    }
    if (lane == 0) {
      tb.span[2 * warp] = first;
      tb.span[2 * warp + 1] = last;
    }
  } else if (warp == 2) {
    // lane pz: the z samples of pz folded into planes with summed
    // weights (a plane whose weights sum to 0 adds nothing)
    int zp[kMaxPlanes];
    float zw[kMaxPlanes];
    int np = 0;
    for (int iz = 0; lane < out_d && iz < sn; ++iz) {
      const Tap t = tap(f.sz, f.bz, lane, iz, sn, f.D);
      if (!t.in) continue;
      const int zs[2] = {t.lo, t.hi};
      const float ws[2] = {t.wl, t.wh};
      for (int k = 0; k < 2; ++k) {
        int q = 0;
        while (q < np && zp[q] != zs[k]) ++q;
        if (q == np) {
          zp[np] = zs[k];
          zw[np++] = 0.0f;
        }
        zw[q] = __fadd_rn(zw[q], ws[k]);
      }
    }
    int kept = 0;
    for (int q = 0; q < np; ++q) {
      if (zw[q] != 0.0f) {
        zp[kept] = zp[q];
        zw[kept++] = zw[q];
      }
    }
    // inclusive prefix sum of the lanes' plane counts
    int incl = kept;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int j0 = incl - kept;
    for (int q = 0; q < kept; ++q) {
      tb.plane[j0 + q] = zp[q];
      tb.w[j0 + q] = zw[q];
    }
    if (lane < out_d) tb.item0[lane] = j0;
    if (lane == 31) tb.item0[out_d] = incl;
  }
  __syncthreads();
}

// The output of one roi and channel block: (cb, out_d, o*o) at out_n, a
// channel every cstride elements.  A warp per channel, its lanes along
// the channel's run.
template <typename T>
struct OutBlock {
  T* out_n;
  int cb, cstride, oo;

  __device__ void store(int pz, const T* tile, int tp) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    T* dst = out_n + pz * oo;
    for (int c = warp; c < cb; c += blockDim.x / 32)
      for (int pos = lane; pos < oo; pos += 32)
        dst[c * cstride + pos] = tile[c * tp + pos];
  }
  // zeros for `planes` depth planes from pz on
  __device__ void zero(int pz, int planes) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    T* dst = out_n + pz * oo;
    for (int c = warp; c < cb; c += blockDim.x / 32)
      for (int e = lane; e < planes * oo; e += 32)
        to_out(dst + c * cstride + e, 0.0f);
  }
};

// grid (rois, channel blocks): block (n, cz) writes out[n, cz*cb:(cz+1)*cb]
// for every output depth plane pz in turn.  A roi whose window does not
// fit goes on the direct list (direct[0] rois at direct + 2) for
// roi_align3d_direct_kernel.  SN, the samples per bin and axis, is a
// template parameter so that the tap loops unroll and their loads issue
// together.
template <typename T, int SN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
roi_align3d_kernel(Levels lv, const float* __restrict__ rois,
                   const int* __restrict__ levels,
                   const unsigned char* __restrict__ valid,
                   T* __restrict__ out,
                   unsigned long long* __restrict__ path_rois,
                   int* __restrict__ direct, int channels, int out_size,
                   int out_d, int smem_bytes) {
  constexpr int sn = SN;
  constexpr int N = Vec<T>::N;
  constexpr int elt = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoiTables tb;

  const int n = blockIdx.x, tid = threadIdx.x;
  const int o = out_size, oo = o * o, tp = tile_pitch(o);
  const int cb = channel_block(channels), c0 = blockIdx.y * cb;
  const int groups = cb / N;
  const OutBlock<T> ob{
      out + (static_cast<size_t>(n) * channels + c0) * out_d * oo, cb,
      out_d * oo, oo};

  // the roi's flag, level and box, loaded together (one latency)
  float box[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) box[k] = __ldg(rois + n * 7 + k);
  const int l = __ldg(levels + n);
  if (!__ldg(valid + n)) {
    ob.zero(0, out_d);
    return;
  }
  const Frame f = roi_frame(lv, box, l, o, out_d);
  roi_tables(tb, f, o, out_d, sn);

  const int x0 = tb.span[0], y0 = tb.span[2];
  const int nx = tb.span[1] < 0 ? 0 : tb.span[1] - x0 + 1;
  const int ny = tb.span[3] < 0 ? 0 : tb.span[3] - y0 + 1;
  const int items = tb.item0[out_d];
  const bool windowed = window_bytes(nx, ny, cb, o, elt) <=
                        static_cast<size_t>(smem_bytes);
  if (blockIdx.y == 0 && tid == 0) {
    atomicAdd(path_rois + (windowed ? 0 : 1), 1ULL);
    if (!windowed) direct[2 + atomicAdd(direct, 1)] = n;
  }
  if (!windowed) return;
  if (nx == 0 || ny == 0 || items == 0) {
    ob.zero(0, out_d);
    return;
  }

  const size_t row_elems = static_cast<size_t>(f.W) * channels;
  const size_t plane_elems = static_cast<size_t>(f.H) * row_elems;
  const T* fb = static_cast<const T*>(lv.ptr[l]) +
                static_cast<size_t>(f.b) * f.D * plane_elems + c0;
  // the bin mean: 1 / sn^3 (a power of two for sn = 1, 2, 4)
  const float inv_count = 1.0f / static_cast<float>(sn * sn * sn);

  // shared memory: X, the output tile, then a ring of staged planes; a
  // staged voxel holds the block's cb channels
  const int voxel_bytes = cb * elt;
  const int row_bytes = nx * voxel_bytes;
  const int stage_bytes = ny * row_bytes;
  const int x_bytes = ny * o * cb * 4;
  const int tile_bytes = cb * tp * elt;
  float* X = reinterpret_cast<float*>(smem);
  T* tile = reinterpret_cast<T*>(smem + x_bytes);
  unsigned char* stage = smem + x_bytes + tile_bytes;
  // planes in flight: the ring runs across depth planes, so the next
  // depth plane's planes stream in while this one is finished
  const int nbuf = min(min(items, kMaxInFlight),
                       (smem_bytes - x_bytes - tile_bytes) / stage_bytes);
  const int chunks_per_voxel = voxel_bytes / 16;
  const int chunks_per_row = nx * chunks_per_voxel;
  auto issue = [&](int j) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        fb + static_cast<size_t>(tb.plane[j]) * plane_elems +
        static_cast<size_t>(y0) * row_elems +
        static_cast<size_t>(x0) * channels);
    unsigned char* buf = stage + (j % nbuf) * stage_bytes;
    const size_t pitch = row_elems * elt;
    for (int ch = tid; ch < ny * chunks_per_row; ch += blockDim.x) {
      const int r = ch / chunks_per_row, rem = ch - r * chunks_per_row;
      const int v = rem / chunks_per_voxel, k = rem - v * chunks_per_voxel;
      cp_async16(buf + r * row_bytes + rem * 16,
                 src + r * pitch + static_cast<size_t>(v) * channels * elt +
                     k * 16);
    }
    cp_async_commit();
  };
  for (int j = 0; j < nbuf; ++j) issue(j);

  // a thread keeps channel group cg; threads past whole sets of groups
  // take no items
  const int xrows = ny * o;
  const int cg = tid % groups, rstep = blockDim.x / groups;
  const int item_first = tid < rstep * groups ? tid / groups : INT_MAX / 2;
  // (row, column) of the first item: the X items' (r, px) and the output
  // items' (py, px) advance from it by rstep without division
  const int r_first = item_first / o, px_first = item_first - r_first * o;
  for (int pz = 0; pz < out_d; ++pz) {
    const int j0 = tb.item0[pz], j1 = tb.item0[pz + 1];
    if (j0 == j1) {
      ob.zero(pz, 1);
      continue;
    }
    for (int j = j0; j < j1; ++j) {
      cp_async_wait_n(min(items, j + nbuf) - j - 1);
      __syncthreads();
      const unsigned char* buf = stage + (j % nbuf) * stage_bytes;
      const float w = tb.w[j];
      // X items (row, px, channel group), the group fastest:
      // neighbouring threads read one voxel's contiguous bytes
      int r = r_first, px = px_first;
      for (int rp = item_first; rp < xrows; rp += rstep) {
        const unsigned char* row = buf + r * row_bytes + cg * 16;
        float acc[N] = {};
#pragma unroll
        for (int ix = 0; ix < sn; ++ix) {
          const Lerp b = tb.tx[px * sn + ix];
          float u[N], v[N];
          Vec<T>::load(row + (b.lo - x0) * voxel_bytes, u);
          Vec<T>::load(row + (b.hi - x0) * voxel_bytes, v);
#pragma unroll
          for (int q = 0; q < N; ++q) acc[q] += b.wl * u[q] + b.wh * v[q];
        }
        float4* xp = reinterpret_cast<float4*>(
            X + (static_cast<size_t>(rp) * groups + cg) * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          float4 s = j > j0 ? xp[q] : make_float4(0.f, 0.f, 0.f, 0.f);
          s.x += w * acc[4 * q];
          s.y += w * acc[4 * q + 1];
          s.z += w * acc[4 * q + 2];
          s.w += w * acc[4 * q + 3];
          xp[q] = s;
        }
        for (px += rstep; px >= o; px -= o) ++r;
      }
      __syncthreads();  // X is complete; buffer j % nbuf is free
      if (j + nbuf < items) issue(j + nbuf);
    }

    // y taps from X into the tile, then the tile out
    int py = r_first, px = px_first;
    for (int pos = item_first; pos < oo; pos += rstep) {
      float acc[N] = {};
#pragma unroll
      for (int iy = 0; iy < sn; ++iy) {
        const Lerp a = tb.ty[py * sn + iy];
        const float4* u = reinterpret_cast<const float4*>(
            X + (static_cast<size_t>((a.lo - y0) * o + px) * groups + cg) *
                    N);
        const float4* v = reinterpret_cast<const float4*>(
            X + (static_cast<size_t>((a.hi - y0) * o + px) * groups + cg) *
                    N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 s = u[q], t = v[q];
          acc[4 * q] += a.wl * s.x + a.wh * t.x;
          acc[4 * q + 1] += a.wl * s.y + a.wh * t.y;
          acc[4 * q + 2] += a.wl * s.z + a.wh * t.z;
          acc[4 * q + 3] += a.wl * s.w + a.wh * t.w;
        }
      }
#pragma unroll
      for (int q = 0; q < N; ++q)
        to_out(tile + (cg * N + q) * tp + pos, acc[q] * inv_count);
      for (px += rstep; px >= o; px -= o) ++py;
    }
    __syncthreads();
    ob.store(pz, tile, tp);
  }
}

// The rois on the direct list, read from device memory directly: a
// persistent grid takes (roi, depth plane, channel block) items in turn,
// so a few large rois spread over every SM.  Per (py, px, channel group),
// every tap is two 16-byte loads from L1/L2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align3d_direct_kernel(Levels lv, const float* __restrict__ rois,
                          const int* __restrict__ levels,
                          T* __restrict__ out, int* __restrict__ direct,
                          int channels, int out_size, int out_d, int sn) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoiTables tb;
  __shared__ int work;
  const int tid = threadIdx.x;
  const int o = out_size, oo = o * o, tp = tile_pitch(o);
  const int cb = channel_block(channels), ncb = channels / cb;
  const int groups = cb / N;
  const int per_roi = out_d * ncb, total = direct[0] * per_roi;
  const float inv_count = 1.0f / static_cast<float>(sn * sn * sn);
  T* tile = reinterpret_cast<T*>(smem);
  if (total == 0) return;  // no roi took the direct path
  for (;;) {
    if (tid == 0) work = atomicAdd(direct + 1, 1);
    __syncthreads();
    const int item = work;
    if (item >= total) return;
    const int n = direct[2 + item / per_roi];
    const int rem = item % per_roi, pz = rem / ncb, c0 = rem % ncb * cb;
    float box[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) box[k] = __ldg(rois + n * 7 + k);
    const int l = __ldg(levels + n);
    const Frame f = roi_frame(lv, box, l, o, out_d);
    roi_tables(tb, f, o, out_d, sn);
    const OutBlock<T> ob{
        out + (static_cast<size_t>(n) * channels + c0) * out_d * oo, cb,
        out_d * oo, oo};
    const int j0 = tb.item0[pz], j1 = tb.item0[pz + 1];
    if (j0 == j1 || tb.span[1] < 0 || tb.span[3] < 0) {
      ob.zero(pz, 1);
      __syncthreads();
      continue;
    }
    const size_t row_elems = static_cast<size_t>(f.W) * channels;
    const size_t plane_elems = static_cast<size_t>(f.H) * row_elems;
    const T* fb = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(f.b) * f.D * plane_elems + c0;
    for (int e = tid; e < oo * groups; e += blockDim.x) {
      const int cg = e % groups, pos = e / groups;
      const int px = pos % o, py = pos / o;
      float acc[N] = {};
      for (int j = j0; j < j1; ++j) {
        const T* zp =
            fb + static_cast<size_t>(tb.plane[j]) * plane_elems + cg * N;
        float ys[N] = {};
        for (int iy = 0; iy < sn; ++iy) {
          const Lerp a = tb.ty[py * sn + iy];
          const int yy[2] = {a.lo, a.hi};
          const float wy[2] = {a.wl, a.wh};
          for (int cy = 0; cy < 2; ++cy) {
            const T* row = zp + yy[cy] * row_elems;
            float xs[N] = {};
            for (int ix = 0; ix < sn; ++ix) {
              const Lerp b = tb.tx[px * sn + ix];
              float u[N], v[N];
              Vec<T>::load(row + static_cast<size_t>(b.lo) * channels, u);
              Vec<T>::load(row + static_cast<size_t>(b.hi) * channels, v);
#pragma unroll
              for (int q = 0; q < N; ++q) xs[q] += b.wl * u[q] + b.wh * v[q];
            }
#pragma unroll
            for (int q = 0; q < N; ++q) ys[q] += wy[cy] * xs[q];
          }
        }
#pragma unroll
        for (int q = 0; q < N; ++q) acc[q] += tb.w[j] * ys[q];
      }
#pragma unroll
      for (int q = 0; q < N; ++q)
        to_out(tile + (cg * N + q) * tp + pos, acc[q] * inv_count);
    }
    __syncthreads();
    ob.store(pz, tile, tp);
    __syncthreads();  // the tables, the tile and `work` are free
  }
}

// one thread per (roi, tap): the x, y and z taps of every roi, as the
// align kernel computes them
__global__ void roi_align3d_taps_kernel(Levels lv,
                                        const float* __restrict__ rois,
                                        const int* __restrict__ levels,
                                        int n, int out_size, int out_d,
                                        int sn, int* __restrict__ lo,
                                        int* __restrict__ hi,
                                        float* __restrict__ wl,
                                        float* __restrict__ wh,
                                        unsigned char* __restrict__ in) {
  const int per_roi = (2 * out_size + out_d) * sn;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * per_roi) return;
  const int i = e / per_roi, k = e - i * per_roi;
  const int l = levels[i];
  const Frame f = roi_frame(lv, rois + static_cast<size_t>(i) * 7, l,
                            out_size, out_d);
  const int ntap = out_size * sn;
  Tap t;
  if (k < ntap)
    t = tap(f.sx, f.bx, k / sn, k % sn, sn, f.W);
  else if (k < 2 * ntap)
    t = tap(f.sy, f.by, (k - ntap) / sn, (k - ntap) % sn, sn, f.H);
  else
    t = tap(f.sz, f.bz, (k - 2 * ntap) / sn, (k - 2 * ntap) % sn, sn, f.D);
  lo[e] = t.lo;
  hi[e] = t.hi;
  wl[e] = t.wl;
  wh[e] = t.wh;
  in[e] = t.in ? 1 : 0;
}

template <typename T, int SN>
cudaError_t launch_window(const Levels& lv, const void* rois,
                          const void* levels, const void* valid, void* out,
                          void* path_rois, void* direct, int n, int channels,
                          int out_size, int out_d, int smem_bytes,
                          cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      roi_align3d_kernel<T, SN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const int ncb = channels / channel_block(channels);
  roi_align3d_kernel<T, SN><<<dim3(n, ncb), kThreads, smem_bytes, s>>>(
      lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out),
      static_cast<unsigned long long*>(path_rois), static_cast<int*>(direct),
      channels, out_size, out_d, smem_bytes);
  return cudaGetLastError();
}

template <typename T>
int launch(const Levels& lv, const void* rois, const void* levels,
           const void* valid, void* out, void* path_rois, void* direct,
           int n, int channels, int out_size, int out_d, int sn,
           int smem_bytes, cudaStream_t s) {
  cudaError_t err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(direct, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (sn) {
#define MRCNN3D_WINDOW(SN)                                                  \
  case SN:                                                                  \
    err = launch_window<T, SN>(lv, rois, levels, valid, out, path_rois,     \
                               direct, n, channels, out_size, out_d,       \
                               smem_bytes, s);                              \
    break;
    MRCNN3D_WINDOW(1)
    MRCNN3D_WINDOW(2)
    MRCNN3D_WINDOW(3)
    MRCNN3D_WINDOW(4)
#undef MRCNN3D_WINDOW
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncb = channels / channel_block(channels);
  const int tile = channel_block(channels) * tile_pitch(out_size) *
                   static_cast<int>(sizeof(T));
  const int blocks = min(n * out_d * ncb, sms * kBlocksPerSM);
  err = cudaFuncSetAttribute(roi_align3d_direct_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  roi_align3d_direct_kernel<T><<<blocks, kThreads, tile, s>>>(
      lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<T*>(out), static_cast<int*>(direct), channels, out_size,
      out_d, sn);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward: the gradient of the align with respect to the levels.
//
// No TPU counterpart: the JAX package differentiates its dense XLA align
// (mrcnn3d/ops/roi_align3d.py:multi_level_roi_align_3d_dense).  The
// reference's method (ROIAlignBackward3D) scatters each sample's bin
// gradient / sn^3 times its 8 trilinear corner weights with atomicAdd.
// The taps here are the forward's (roi_frame, tap, roi_tables), so the
// gradient lands on the voxels the forward read.
//
// Design: two kernels, one per launch, chosen by the align's geometry.
// The trilinear weights are per-axis products, and a bin's samples fold
// per axis into distinct voxels with summed weights (the z planes of
// roi_tables, fold_bin for y and x).  A scatter from the bins adds once
// per (bin, folded voxel); where a roi has many bins, many of them land
// on each voxel of its window: a mask roi (14 x 14 x 10 bins) adds 36-224
// times per value of its window at the training shapes, a bbox roi (7 x
// 7 x 3) 5-21 times.  So a launch whose rois have at least
// kContractBins (512) bins contracts, the others scatter.
//   * Scatter (roi_align3d_backward_kernel): one block of 128 threads
//     per (roi, 32 channels, depth plane pz) stages pz's bin gradients in
//     shared memory (rows of a channel read contiguously from (N, C, od,
//     o, o)); then a warp takes one bin and its lanes the channels, and
//     adds each folded voxel with one float atomicAdd, so each atomic
//     instruction of a warp adds to one voxel's 32 contiguous floats.  A
//     block per depth plane keeps the card busy when few rois are valid
//     and spreads a roi's atomics over time.
//   * Contraction (roi_align3d_backward_contract_kernel): one block of
//     256 threads per (roi, 16 channels, z group); block z takes the z
//     planes zmin + z, zmin + z + Q, ... of the roi (Q = od / 3 groups)
//     and computes each plane's gradient on the roi's window (the span
//     of its in-range taps) in shared memory, in chunks of at most kChunk
//     x kChunk voxels, as a separable sum:
//         G[py, px, c] = sum_pz wz(pz, zz) g[c, pz, py, px] / sn^3
//         T[py, x, c]  = sum_px wx(px, x) G[py, px, c]
//         grad[zz, y, x, c] += sum_py wy(py, y) T[py, x, c]
//     a thread per (row, column, channel) of each step, summing in
//     registers; then it adds each voxel's 16 channels with four 16-byte
//     atomics (red.global.add.v4.f32), skipping voxels no tap reached.
//     A voxel gets one add per roi where the scatter adds once per bin.
// The gradient is a float32 buffer, zeroed first (cudaMemsetAsync); the
// wrapper casts it to a bfloat16 level's dtype.  Atomics add in an order
// that changes from run to run, so the result varies in its last bits.
//
// What bounds it: the atomics into L2 (scatter) and the roi's setup and
// four barriers per z plane (contraction); the bytes it must move (each
// touched gradient voxel and grad_out once) bound it far lower, and the
// memset writes every voxel of the levels.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;  // threads of a contraction block
constexpr int kBwdChannels = 16;  // channels of a contraction block
constexpr int kChunk = 16;  // y and x voxels of a window chunk
// a launch contracts when its rois have at least this many bins
constexpr int kContractBins = 512;
constexpr int kMaxDevices = 16;

// distinct voxels of one output bin along one axis, with summed weights
struct Fold {
  int idx[kMaxPlanes];
  float w[kMaxPlanes];
  int n;
};

// folds the sn taps of bin p (weights 0 add nothing) in tap order
__device__ void fold_bin(Fold& f, const Lerp* taps, int p, int sn) {
  f.n = 0;
  for (int i = 0; i < sn; ++i) {
    const Lerp t = taps[p * sn + i];
    const int vs[2] = {t.lo, t.hi};
    const float ws[2] = {t.wl, t.wh};
    for (int k = 0; k < 2; ++k) {
      if (ws[k] == 0.0f) continue;
      int q = 0;
      while (q < f.n && f.idx[q] != vs[k]) ++q;
      if (q == f.n) {
        f.idx[f.n] = vs[k];
        f.w[f.n++] = 0.0f;
      }
      f.w[q] = __fadd_rn(f.w[q], ws[k]);
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid (rois, channel blocks, od): block (n, cz, pz) scatters roi n's
// depth plane pz.  grad: one float32 (B, D, H, W, C) buffer per level
// (lv.ptr), zeroed before the launch.  grad_out (N, C, od, o, o)
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align3d_backward_kernel(Levels lv, const float* __restrict__ rois,
                            const int* __restrict__ levels,
                            const unsigned char* __restrict__ valid,
                            const T* __restrict__ grad_out, int channels,
                            int out_size, int out_d, int sn) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoiTables tb;
  __shared__ Fold fx[kMaxTaps], fy[kMaxTaps];

  const int n = blockIdx.x, tid = threadIdx.x;
  const int o = out_size, oo = o * o, tp = tile_pitch(o);
  const int cb = channel_block(channels), c0 = blockIdx.y * cb;
  float box[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) box[k] = __ldg(rois + n * 7 + k);
  const int l = __ldg(levels + n);
  if (!__ldg(valid + n)) return;
  const Frame f = roi_frame(lv, box, l, o, out_d);
  roi_tables(tb, f, o, out_d, sn);
  if (tid < o) fold_bin(fx[tid], tb.tx, tid, sn);
  if (tid >= 64 && tid - 64 < o) fold_bin(fy[tid - 64], tb.ty, tid - 64, sn);
  __syncthreads();
  if (tb.span[1] < 0 || tb.span[3] < 0) return;  // no x or y tap in range

  float* tile = reinterpret_cast<float*>(smem);  // (cb, tp) bin gradients
  float* gb = static_cast<float*>(const_cast<void*>(lv.ptr[l])) +
              static_cast<size_t>(f.b) * f.D * f.H * f.W * channels + c0;
  const T* go = grad_out + (static_cast<size_t>(n) * channels + c0) *
                               out_d * oo;
  const float inv_count = 1.0f / static_cast<float>(sn * sn * sn);
  const int pz = blockIdx.z;
  const int j0 = tb.item0[pz], j1 = tb.item0[pz + 1];
  if (j0 == j1) return;  // no z plane in range
  for (int e = tid; e < cb * oo; e += blockDim.x) {
    const int c = e / oo, pos = e - c * oo;
    tile[c * tp + pos] =
        to_float(go[(static_cast<size_t>(c) * out_d + pz) * oo + pos]);
  }
  __syncthreads();
  for (int e = tid; e < cb * oo; e += blockDim.x) {
    const int pos = e / cb, c = e - pos * cb;
    const float g = tile[c * tp + pos] * inv_count;
    if (g == 0.0f) continue;
    const Fold& ay = fy[pos / o];
    const Fold& ax = fx[pos % o];
    for (int j = j0; j < j1; ++j) {
      float* zp =
          gb + static_cast<size_t>(tb.plane[j]) * f.H * f.W * channels + c;
      const float gz = g * tb.w[j];
      for (int a = 0; a < ay.n; ++a) {
        float* row = zp + static_cast<size_t>(ay.idx[a]) * f.W * channels;
        const float gzy = gz * ay.w[a];
        for (int b = 0; b < ax.n; ++b)
          atomicAdd(row + static_cast<size_t>(ax.idx[b]) * channels,
                    gzy * ax.w[b]);
      }
    }
  }
}

// channels of one backward block: all of them up to kBwdChannels
__host__ __device__ __forceinline__ int bwd_channel_block(int channels) {
  return channels < kBwdChannels ? channels : kBwdChannels;
}

// floats of a backward block's dynamic shared memory: G (o*o rows of
// cb + 1, padded to 16 bytes), T (o, kChunk, cb), the chunk's gradient
// (kChunk, kChunk, cb), and the chunk's x and y weights (o, kChunk) each
__host__ __device__ __forceinline__ int backward_floats(int cb, int o) {
  return ((o * o * (cb + 1) + 3) & ~3) + o * kChunk * cb +
         kChunk * kChunk * cb + 2 * o * kChunk;
}

// grid (rois, channel blocks, Q): block (n, cz, z) adds roi n's gradient
// for channels cz*cb..(cz+1)*cb to its z planes zmin + z, zmin + z + Q,
// ...  grad: one float32 (B, D, H, W, C) buffer per level (lv.ptr),
// zeroed before the launch.  grad_out (N, C, od, o, o)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
roi_align3d_backward_contract_kernel(
    Levels lv, const float* __restrict__ rois, const int* __restrict__ levels,
    const unsigned char* __restrict__ valid, const T* __restrict__ grad_out,
    int channels, int out_size, int out_d, int sn) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoiTables tb;
  __shared__ Fold fx[kMaxTaps], fy[kMaxTaps];
  __shared__ float zw[kMaxOutD];  // each depth plane's weight on plane zz
  __shared__ int zspan[2];

  const int n = blockIdx.x, tid = threadIdx.x;
  const int o = out_size, oo = o * o;
  const int cb = bwd_channel_block(channels), c0 = blockIdx.y * cb;
  float box[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) box[k] = __ldg(rois + n * 7 + k);
  const int l = __ldg(levels + n);
  if (!__ldg(valid + n)) return;
  const Frame f = roi_frame(lv, box, l, o, out_d);
  roi_tables(tb, f, o, out_d, sn);
  if (tid < o) fold_bin(fx[tid], tb.tx, tid, sn);
  if (tid >= 64 && tid - 64 < o) fold_bin(fy[tid - 64], tb.ty, tid - 64, sn);
  if (tid >= 32 && tid < 64) {  // warp 1: the span of the z planes
    int lo = INT_MAX, hi = -1;
    for (int j = tid - 32; j < tb.item0[out_d]; j += 32) {
      lo = min(lo, tb.plane[j]);
      hi = max(hi, tb.plane[j]);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (tid == 32) {
      zspan[0] = lo;
      zspan[1] = hi;
    }
  }
  __syncthreads();
  // no x, y or z tap in range
  if (tb.span[1] < 0 || tb.span[3] < 0 || zspan[1] < 0) return;

  const int pg = cb + 1;  // G's row pitch: conflict-free by row and by lane
  float* G = reinterpret_cast<float*>(smem);
  float* Tx = G + ((oo * pg + 3) & ~3);
  float* A = Tx + o * kChunk * cb;
  float* Wx = A + kChunk * kChunk * cb;
  float* Wy = Wx + o * kChunk;
  const T* go = grad_out + (static_cast<size_t>(n) * channels + c0) *
                               out_d * oo;
  const float inv_count = 1.0f / static_cast<float>(sn * sn * sn);
  const size_t row = static_cast<size_t>(f.W) * channels;
  const size_t plane = static_cast<size_t>(f.H) * row;
  float* gb = static_cast<float*>(const_cast<void*>(lv.ptr[l])) +
              static_cast<size_t>(f.b) * f.D * plane + c0;
  const int x0 = tb.span[0], nx = tb.span[1] - x0 + 1;
  const int y0 = tb.span[2], ny = tb.span[3] - y0 + 1;
  if (zspan[0] + static_cast<int>(blockIdx.z) > zspan[1]) return;
  const int cx = min(nx, kChunk), cy = min(ny, kChunk);
  const int cq = cb / 4;  // 16-byte groups of a voxel's channels
  for (int ya = y0; ya < y0 + ny; ya += cy) {
    for (int xa = x0; xa < x0 + nx; xa += cx) {
      // the chunk's weights: Wx (o, cx), Wy (o, cy), a bin's row by one
      // thread
      for (int e = tid; e < o * (cx + cy); e += blockDim.x)
        (e < o * cx ? Wx[e] : Wy[e - o * cx]) = 0.0f;
      __syncthreads();
      if (tid < o) {
        const Fold& a = fx[tid];
        for (int k = 0; k < a.n; ++k)
          if (a.idx[k] >= xa && a.idx[k] < xa + cx)
            Wx[tid * cx + a.idx[k] - xa] = a.w[k];
      } else if (tid >= 64 && tid - 64 < o) {
        const Fold& a = fy[tid - 64];
        for (int k = 0; k < a.n; ++k)
          if (a.idx[k] >= ya && a.idx[k] < ya + cy)
            Wy[(tid - 64) * cy + a.idx[k] - ya] = a.w[k];
      }
      for (int zz = zspan[0] + blockIdx.z; zz <= zspan[1];
           zz += gridDim.z) {
        if (tid < 32) {
          for (int pz = tid; pz < out_d; pz += 32) {
            float w = 0.0f;
            for (int j = tb.item0[pz]; j < tb.item0[pz + 1]; ++j)
              if (tb.plane[j] == zz) w = tb.w[j];
            zw[pz] = w;
          }
        }
        __syncthreads();
        for (int e = tid; e < cb * oo; e += blockDim.x) {
          const int c = e / oo, pos = e - c * oo;
          const T* gc = go + static_cast<size_t>(c) * out_d * oo + pos;
          float v = 0.0f;
          for (int pz = 0; pz < out_d; ++pz) {
            const float w = zw[pz];
            if (w != 0.0f) v += w * to_float(gc[pz * oo]);
          }
          G[pos * pg + c] = v * inv_count;
        }
        __syncthreads();
        for (int e = tid; e < o * cx * cb; e += blockDim.x) {
          const int c = e % cb, r = e / cb, xi = r % cx, py = r / cx;
          const float* gr = G + py * o * pg + c;
          float v = 0.0f;
          for (int px = 0; px < o; ++px) {
            const float w = Wx[px * cx + xi];
            if (w != 0.0f) v += w * gr[px * pg];
          }
          Tx[e] = v;
        }
        __syncthreads();
        for (int e = tid; e < cy * cx * cb; e += blockDim.x) {
          const int c = e % cb, r = e / cb, xi = r % cx, yi = r / cx;
          float v = 0.0f;
          for (int py = 0; py < o; ++py) {
            const float w = Wy[py * cy + yi];
            if (w != 0.0f) v += w * Tx[(py * cx + xi) * cb + c];
          }
          A[e] = v;
        }
        __syncthreads();
        float* gz = gb + static_cast<size_t>(zz) * plane;
        for (int e = tid; e < cy * cx * cq; e += blockDim.x) {
          const float4 v = reinterpret_cast<const float4*>(A)[e];
          if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f)
            continue;
          const int vox = e / cq, q = e - vox * cq;
          const int y = ya + vox / cx, x = xa + vox % cx;
          atomicAdd(reinterpret_cast<float4*>(
                        gz + y * row + static_cast<size_t>(x) * channels +
                        4 * q),
                    v);
        }
      }
      __syncthreads();  // the chunk's weights are read before the next's
    }
  }
}

// sets fn's dynamic shared memory to at least `bytes`, once per device
template <typename F>
cudaError_t reserve_smem(F* fn, int bytes, int* set_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= set_bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set_bytes[dev] = bytes;
  return err;
}

template <typename T>
int launch_backward(const Levels& lv, const void* rois, const void* levels,
                    const void* valid, const void* grad_out, void* grad,
                    size_t grad_bytes, int n, int channels, int out_size,
                    int out_d, int sn, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(grad, 0, grad_bytes, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  // the attributes are set once, not on every launch
  static int scatter_bytes[kMaxDevices] = {};
  static int contract_bytes[kMaxDevices] = {};
  const float* r = static_cast<const float*>(rois);
  const int* lvl = static_cast<const int*>(levels);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  const T* go = static_cast<const T*>(grad_out);
  if (out_size * out_size * out_d >= kContractBins) {
    const int cb = bwd_channel_block(channels);
    const int smem = backward_floats(cb, out_size) * 4;
    err = reserve_smem(roi_align3d_backward_contract_kernel<T>, smem,
                       contract_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int groups = out_d / 3 > 1 ? out_d / 3 : 1;
    roi_align3d_backward_contract_kernel<T>
        <<<dim3(n, channels / cb, groups), kBwdThreads, smem, s>>>(
            lv, r, lvl, ok, go, channels, out_size, out_d, sn);
  } else {
    const int cb = channel_block(channels);
    const int tile = cb * tile_pitch(out_size) * 4;
    err = reserve_smem(roi_align3d_backward_kernel<T>, tile, scatter_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_align3d_backward_kernel<T>
        <<<dim3(n, channels / cb, out_d), kThreads, tile, s>>>(
            lv, r, lvl, ok, go, channels, out_size, out_d, sn);
  }
  return static_cast<int>(cudaGetLastError());
}

Levels make_levels(const long long* level_ptrs, const int* level_dims,
                   const float* level_scales, int num_levels) {
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = reinterpret_cast<const void*>(level_ptrs[i]);
    lv.d[i] = level_dims[3 * i];
    lv.h[i] = level_dims[3 * i + 1];
    lv.w[i] = level_dims[3 * i + 2];
    lv.scale[i] = level_scales[2 * i];
    lv.scale_d[i] = level_scales[2 * i + 1];
  }
  return lv;
}

}  // namespace

// level_ptrs[L]: (B, D, H, W, C) storage of each level, 16-byte aligned;
// level_dims[L*3]: (D, H, W); level_scales[L*2]: (1/stride_xy,
// 1/stride_d).  rois (n, 7) f32 [b, x1, y1, x2, y2, z1, z2]; levels (n,)
// i32; valid (n,) u8 (a bool tensor).  dtype 0 = float32, 1 = bfloat16;
// a block's channels (all, or 32 of them) must fill 16-byte vectors and
// divide the channels.  out (n, C, od, o, o) of that dtype.  path_rois:
// two u64 counters, incremented per valid roi by the path it took
// (window, direct).  direct: i32 scratch of n + 2, the direct list.
// smem_bytes: dynamic shared memory per block, the window path's budget.
// Two launches: the window kernel, then the direct kernel.
extern "C" int mrcnn3d_roi_align3d(const long long* level_ptrs,
                                   const int* level_dims,
                                   const float* level_scales, int num_levels,
                                   int dtype, int channels, const void* rois,
                                   const void* levels, const void* valid,
                                   void* out, void* path_rois, void* direct,
                                   int n, int out_size, int out_d,
                                   int sample_num, int smem_bytes,
                                   void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  if (num_levels < 1 || num_levels > kMaxLevels || sample_num < 1 ||
      sample_num > kMaxSamples || out_size * sample_num > kMaxTaps ||
      out_d < 1 || out_d > kMaxOutD ||
      channels < 1 || channels % channel_block(channels) != 0 ||
      channel_block(channels) * elt % 16 != 0 ||
      static_cast<size_t>(channel_block(channels)) * tile_pitch(out_size) *
              elt >
          static_cast<size_t>(smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Levels lv =
      make_levels(level_ptrs, level_dims, level_scales, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(lv, rois, levels, valid, out, path_rois, direct, n,
                         channels, out_size, out_d, sample_num, smem_bytes,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(lv, rois, levels, valid, out, path_rois,
                                 direct, n, channels, out_size, out_d,
                                 sample_num, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: level_ptrs[L] are float32 (B, D, H, W, C) gradient
// buffers, parts of one allocation of grad_bytes at grad, which is zeroed
// first; dims, scales, rois, levels and valid as for mrcnn3d_roi_align3d;
// grad_out (n, C, od, o, o) of dtype 0 = float32, 1 = bfloat16.  The
// channels must be a multiple of 4 and of a scatter block's (all, or 32)
// and a contraction block's (all, or 16) channels; each level's buffer
// starts 16-byte aligned.  Two launches: the memset, then the scatter or
// the contraction.  The gradients add up in an order that varies between
// runs.
extern "C" int mrcnn3d_roi_align3d_backward(
    const long long* level_ptrs, const int* level_dims,
    const float* level_scales, int num_levels, int dtype, int channels,
    const void* grad_out, const void* rois, const void* levels,
    const void* valid, void* grad, size_t grad_bytes, int n, int out_size,
    int out_d, int sample_num, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || sample_num < 1 ||
      sample_num > kMaxSamples || out_size * sample_num > kMaxTaps ||
      out_d < 1 || out_d > kMaxOutD || channels < 1 || channels % 4 != 0 ||
      channels % channel_block(channels) != 0 ||
      channels % bwd_channel_block(channels) != 0 ||
      channel_block(channels) * tile_pitch(out_size) * 4 > 227 * 1024 ||
      backward_floats(bwd_channel_block(channels), out_size) * 4 >
          227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv =
      make_levels(level_ptrs, level_dims, level_scales, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(lv, rois, levels, valid, grad_out, grad,
                                  grad_bytes, n, channels, out_size, out_d,
                                  sample_num, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(lv, rois, levels, valid, grad_out,
                                          grad, grad_bytes, n, channels,
                                          out_size, out_d, sample_num, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The taps of every roi as the align kernel computes them: (n, T) arrays
// with T = (2 * out_size + out_d) * sample_num, the x taps, then y, then
// z; lo/hi i32, wl/wh f32, in u8.
extern "C" int mrcnn3d_roi_align3d_taps(
    const long long* level_ptrs, const int* level_dims,
    const float* level_scales, int num_levels, const void* rois,
    const void* levels, int n, int out_size, int out_d, int sample_num,
    void* lo, void* hi, void* wl, void* wh, void* in, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || sample_num < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = n * (2 * out_size + out_d) * sample_num;
  if (total == 0) return 0;
  const Levels lv =
      make_levels(level_ptrs, level_dims, level_scales, num_levels);
  roi_align3d_taps_kernel<<<(total + 255) / 256, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(rois), static_cast<const int*>(levels), n,
      out_size, out_d, sample_num, static_cast<int*>(lo),
      static_cast<int*>(hi), static_cast<float*>(wl), static_cast<float*>(wh),
      static_cast<unsigned char*>(in));
  return static_cast<int>(cudaGetLastError());
}
