// Greedy hard 3-D NMS over many independent problems in one launch.
//
// Replaces the TPU kernel mrcnn3d/ops/nms3d_pallas.py:_nms_scan_kernel
// (called through nms_3d_mask_pallas).  Same function: boxes sorted by
// score, symmetric volume IoU with +1 extents, box i suppressed by an
// earlier kept box when IoU > thr; the keep mask comes back per sorted
// row (the wrapper un-permutes it).
//
// What bounds it on the H100: not bytes (a 2000-box problem reads 48 KB)
// and not arithmetic (2M IoUs), but the greedy scan, a chain of K
// dependent steps.  The design keeps that chain short and on chip:
//   pass 1  (nms3d_mask_kernel) -- all K^2/2 IoU tests in parallel, as
//           64x64 tiles; row i gets ceil(K/64) 64-bit words with bit j
//           set when j > i and iou(i, j) > thr (the reference
//           nms_kernel.cu bitmask scheme);
//   pass 2  (nms3d_scan_kernel) -- one block per problem walks the rows
//           in order with the "removed" bitmask in shared memory; a kept
//           row ORs its mask words in, one word per thread.  Rows that
//           are removed cost one shared-memory read and no barrier.
// Problems ("segments") are independent, so one launch of each pass
// covers e.g. the 5 FPN levels of a scale, each segment on its own
// blocks.  Sorting stays outside, as stable torch sorts.
//
// IoU arithmetic follows bbox_overlaps_3d exactly: inter / (vol_i +
// vol_j - inter), every operation rounded on its own (the _rn intrinsics;
// the file is also built with -fmad=false), so a comparison that sits
// exactly at thr decides as in the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kScanThreads = 128;

__device__ __forceinline__ float extent(float lo, float hi) {
  return __fadd_rn(__fsub_rn(hi, lo), 1.0f);
}

__device__ __forceinline__ float volume(const float* b) {
  return __fmul_rn(__fmul_rn(extent(b[0], b[2]), extent(b[1], b[3])),
                   extent(b[4], b[5]));
}

__device__ __forceinline__ float iou3d(const float* a, float va,
                                       const float* b) {
  float ix = fmaxf(extent(fmaxf(a[0], b[0]), fminf(a[2], b[2])), 0.0f);
  float iy = fmaxf(extent(fmaxf(a[1], b[1]), fminf(a[3], b[3])), 0.0f);
  float iz = fmaxf(extent(fmaxf(a[4], b[4]), fminf(a[5], b[5])), 0.0f);
  float inter = __fmul_rn(__fmul_rn(ix, iy), iz);
  float uni = __fsub_rn(__fadd_rn(va, volume(b)), inter);
  return __fdiv_rn(inter, uni);
}

// grid (col tiles, row tiles, segments), kTile threads: one row each
__global__ void nms3d_mask_kernel(const float* __restrict__ boxes,
                                  const int* __restrict__ seg_start,
                                  const int* __restrict__ seg_count,
                                  const long long* __restrict__ mask_off,
                                  unsigned long long* __restrict__ mask,
                                  float thr) {
  const int seg = blockIdx.z;
  const int n = seg_count[seg];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  if (row0 >= n || col0 >= n) return;  // uniform over the block
  const int words = (n + kTile - 1) / kTile;
  const float* b = boxes + (size_t)seg_start[seg] * 6;
  const int ncol = min(kTile, n - col0);

  __shared__ float cols[kTile * 6];
  for (int t = threadIdx.x; t < ncol * 6; t += blockDim.x)
    cols[t] = b[(size_t)col0 * 6 + t];
  __syncthreads();

  const int i = row0 + threadIdx.x;
  if (i >= n) return;
  unsigned long long bits = 0ULL;
  if (col0 >= row0) {
    float bi[6];
    for (int k = 0; k < 6; ++k) bi[k] = b[(size_t)i * 6 + k];
    const float vi = volume(bi);
    const int first = (col0 == row0) ? threadIdx.x + 1 : 0;
    for (int k = first; k < ncol; ++k) {
      if (iou3d(bi, vi, cols + k * 6) > thr) bits |= 1ULL << k;
    }
  }
  mask[mask_off[seg] + (size_t)i * words + blockIdx.x] = bits;
}

// one block per segment: the greedy scan over the sorted rows
__global__ void nms3d_scan_kernel(const unsigned char* __restrict__ valid,
                                  const int* __restrict__ seg_start,
                                  const int* __restrict__ seg_count,
                                  const long long* __restrict__ mask_off,
                                  const unsigned long long* __restrict__ mask,
                                  unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int seg = blockIdx.x;
  const int n = seg_count[seg];
  const int start = seg_start[seg];
  const int words = (n + kTile - 1) / kTile;
  const unsigned long long* m = mask + mask_off[seg];
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ULL;
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int wi = i / kTile;
    // every thread reads the same word, so `alive` is uniform and the
    // barriers below sit in a uniform branch
    const bool alive =
        valid[start + i] && !((removed[wi] >> (i % kTile)) & 1ULL);
    if (threadIdx.x == 0) keep[start + i] = alive ? 1 : 0;
    if (alive) {
      __syncthreads();  // all reads of removed[wi] precede the writes
      for (int w = wi + threadIdx.x; w < words; w += blockDim.x)
        removed[w] |= m[(size_t)i * words + w];
      __syncthreads();
    }
  }
}

}  // namespace

// boxes (total, 6) f32 and valid (total,) u8 are score-sorted within each
// segment; segment s holds rows [seg_start[s], seg_start[s] + seg_count[s]).
// mask: scratch of sum_s count_s * ceil(count_s / 64) words, segment s at
// word mask_off[s].  keep (total,) u8 out, per sorted row.
extern "C" int mrcnn3d_nms3d(const void* boxes, const void* valid,
                             const void* seg_start, const void* seg_count,
                             const void* mask_off, void* mask, void* keep,
                             int num_segments, int max_count, float thr,
                             void* stream) {
  if (num_segments <= 0 || max_count <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (max_count + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, num_segments);
  nms3d_mask_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_count),
      static_cast<const long long*>(mask_off),
      static_cast<unsigned long long*>(mask), thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(tiles) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms3d_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms3d_scan_kernel<<<num_segments, kScanThreads, smem, s>>>(
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_count),
      static_cast<const long long*>(mask_off),
      static_cast<const unsigned long long*>(mask),
      static_cast<unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}
