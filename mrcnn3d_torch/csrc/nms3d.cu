// Greedy hard 3-D NMS over many independent problems in one launch of
// each of two passes.
//
// Replaces the TPU kernel mrcnn3d/ops/nms3d_pallas.py:_nms_scan_kernel
// (called through nms_3d_mask_pallas).  Same function: boxes sorted by
// score, symmetric volume IoU with +1 extents, box i suppressed by an
// earlier kept box when IoU > thr; the keep flag comes back per sorted
// row (the wrapper un-permutes it).
//
// What bounds it on the H100: not bytes (a 2000-box problem reads 48 KB)
// and not arithmetic (2M IoUs), but the greedy scan, a chain of K
// dependent decisions.  The design keeps only registers on that chain:
//   pass 1  (nms3d_mask_kernel) -- the IoU tests in parallel, one block
//           per 64x64 tile on or above the diagonal (the reference
//           nms_kernel.cu bitmask scheme), four threads per row, each on
//           16 columns whose volumes are computed once: word (i, c) has
//           bit j set when row 64c + j > i is suppressed by row i.  Only
//           the words the scan reads exist: row tile t keeps the words of
//           column tiles t..W-1, row-major, so a row's words are
//           contiguous;
//   pass 2  (nms3d_scan_kernel) -- one warp per problem, a 64-row tile at
//           a time.  The "removed" words live in registers, lane l owning
//           the words of column tiles l, l + 32, ...  In a tile, the keep
//           decisions depend only on the tile's removed word and its 64
//           diagonal words, which are loaded into registers first: the
//           chain is 64 bit steps on a 64-bit register, with no memory
//           access and no barrier.  Then each lane ORs in the kept rows'
//           words of its later tiles: 64 independent loads per word it
//           owns, selected by the kept bits.  The next tile's mask rows
//           stream into shared memory with cp.async, and the next tile's
//           valid flags load, while this tile is resolved.  A segment of
//           more than 128 tiles (8192 rows; SSD300 feeds 8732 anchors to
//           one class's NMS) would need more shared memory for the two
//           buffers than a block has, so its scan reads the mask rows
//           straight from device memory, up to 12 words a lane: 384
//           tiles, 24576 rows.
// Problems ("segments") are independent, so one launch of each pass
// covers e.g. the 5 FPN levels of a scale.  Sorting stays outside, as
// stable torch sorts.  The chain of 64 steps per tile and the OR after
// it keep the scan far above the bound of the IoU operations (PERF.md
// has the times on the card).
//
// IoU arithmetic follows bbox_overlaps_3d exactly: inter / (vol_i +
// vol_j - inter), every operation rounded on its own (the _rn intrinsics;
// the file is also built with -fmad=false), so a comparison that sits
// exactly at thr decides as in the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxTiles = 384;  // 12 words per lane: 24576 rows
constexpr int kMaxStagedSlots = 4;  // 128 tiles staged in shared memory
constexpr int kSplit = 4;       // mask-pass threads per row
constexpr int kMaskThreads = kTile * kSplit;

__device__ __forceinline__ float extent(float lo, float hi) {
  return __fadd_rn(__fsub_rn(hi, lo), 1.0f);
}

__device__ __forceinline__ float volume(const float* b) {
  return __fmul_rn(__fmul_rn(extent(b[0], b[2]), extent(b[1], b[3])),
                   extent(b[4], b[5]));
}

// first word of row tile t in a segment of `words` tiles
__host__ __device__ __forceinline__ long long tile_base(int t, int words) {
  return kTile * (static_cast<long long>(t) * words -
                  static_cast<long long>(t) * (t - 1) / 2);
}

// segment table: starts, counts and mask offsets (in words), nseg each
struct Segments {
  const long long* start;
  const long long* count;
  const long long* mask_off;
};

__device__ __forceinline__ Segments segments(const long long* table,
                                             int nseg) {
  return {table, table + nseg, table + 2 * nseg};
}

// grid (upper-triangular tile pairs of the longest segment, segments),
// kMaskThreads threads: kSplit per row, each testing a quarter of the
// columns; the quarters' bits are OR'd in shared memory
__global__ void __launch_bounds__(kMaskThreads)
nms3d_mask_kernel(const float* __restrict__ boxes,
                  const long long* __restrict__ table, int nseg,
                  unsigned long long* __restrict__ mask, float thr) {
  const Segments sg = segments(table, nseg);
  const int seg = blockIdx.y;
  const int n = static_cast<int>(sg.count[seg]);
  const int words = (n + kTile - 1) / kTile;
  int p = blockIdx.x;
  if (p >= words * (words + 1) / 2) return;  // uniform over the block
  int rt = 0;
  while (p >= words - rt) p -= words - rt++;
  const int ct = rt + p;
  const int row0 = rt * kTile, col0 = ct * kTile;
  const float* b = boxes + sg.start[seg] * 6;
  const int ncol = min(kTile, n - col0);

  __shared__ float cols[kTile * 6];
  __shared__ float col_vol[kTile];
  __shared__ unsigned long long part[kTile];
  for (int t = threadIdx.x; t < ncol * 6; t += blockDim.x)
    cols[t] = b[static_cast<size_t>(col0) * 6 + t];
  if (threadIdx.x < kTile) part[threadIdx.x] = 0ULL;
  __syncthreads();
  if (threadIdx.x < ncol) col_vol[threadIdx.x] = volume(cols + threadIdx.x * 6);
  __syncthreads();

  const int row = threadIdx.x % kTile, q = threadIdx.x / kTile;
  const int i = row0 + row;
  if (i < n) {
    float bi[6];
    for (int k = 0; k < 6; ++k) bi[k] = b[static_cast<size_t>(i) * 6 + k];
    const float vi = volume(bi);
    unsigned long long bits = 0ULL;
    const int k0 = q * (kTile / kSplit);
    const int k1 = min(ncol, k0 + kTile / kSplit);
    for (int k = ct == rt ? max(k0, row + 1) : k0; k < k1; ++k) {
      const float* c = cols + k * 6;
      const float ix = fmaxf(extent(fmaxf(bi[0], c[0]), fminf(bi[2], c[2])),
                             0.0f);
      const float iy = fmaxf(extent(fmaxf(bi[1], c[1]), fminf(bi[3], c[3])),
                             0.0f);
      const float iz = fmaxf(extent(fmaxf(bi[4], c[4]), fminf(bi[5], c[5])),
                             0.0f);
      const float inter = __fmul_rn(__fmul_rn(ix, iy), iz);
      const float uni = __fsub_rn(__fadd_rn(vi, col_vol[k]), inter);
      if (__fdiv_rn(inter, uni) > thr) bits |= 1ULL << k;
    }
    if (bits) atomicOr(part + row, bits);
  }
  __syncthreads();
  if (q == 0 && i < n)
    mask[sg.mask_off[seg] + tile_base(rt, words) +
         static_cast<long long>(row) * (words - rt) + p] = part[row];
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

// one warp per segment: the greedy scan over the sorted rows; lane l owns
// the removed words of column tiles l + 32 s, s < SLOTS.  Up to
// kMaxStagedSlots the row tiles are staged in shared memory; past it they
// are read from device memory, and slots that hold no later tile of the
// warp are skipped.
template <int SLOTS>
__global__ void __launch_bounds__(32)
nms3d_scan_kernel(const unsigned char* __restrict__ valid,
                  const long long* __restrict__ table, int nseg,
                  const unsigned long long* __restrict__ mask,
                  unsigned char* __restrict__ keep) {
  // two buffers of one row tile's words: 64 rows x up to W words
  extern __shared__ __align__(16) unsigned long long rows_buf[];
  const Segments sg = segments(table, nseg);
  const int seg = blockIdx.x, lane = threadIdx.x;
  const int n = static_cast<int>(sg.count[seg]);
  const long long start = sg.start[seg];
  const int words = (n + kTile - 1) / kTile;
  const unsigned long long* m = mask + sg.mask_off[seg];
  const unsigned full = 0xffffffffu;
  constexpr bool kStaged = SLOTS <= kMaxStagedSlots;

  // row tile t -> buffer t & 1 (64 * (words - t) words, an even count)
  auto stage = [&](int t) {
    const unsigned long long* src = m + tile_base(t, words);
    unsigned long long* dst = rows_buf + (t & 1) * kTile * words;
    const int chunks = kTile * (words - t) / 2;
    for (int c = lane; c < chunks; c += 32)
      cp_async16(dst + 2 * c, src + 2 * c);
    cp_async_commit();
  };
  // valid flags of rows 64 t + lane and 64 t + 32 + lane
  auto valid_at = [&](int t, int k) {
    const int i = t * kTile + k;
    return i < n && valid[start + i];
  };

  unsigned long long removed[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) removed[s] = 0ULL;

  bool v0 = false, v1 = false;
  if (words > 0) {
    if constexpr (kStaged) stage(0);
    v0 = valid_at(0, lane);
    v1 = valid_at(0, 32 + lane);
  }
  for (int t = 0; t < words; ++t) {
    if constexpr (kStaged) {
      if (t + 1 < words) {
        stage(t + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncwarp();
    const unsigned long long* rows =
        kStaged ? rows_buf + (t & 1) * kTile * words : m + tile_base(t, words);
    const int stride = words - t;
    const int i0 = t * kTile;

    // candidates: valid rows of the tile not removed by earlier tiles
    unsigned long long cand =
        static_cast<unsigned long long>(__ballot_sync(full, v0)) |
        static_cast<unsigned long long>(__ballot_sync(full, v1)) << 32;
    if (t + 1 < words) {  // the next tile's flags load during this one
      v0 = valid_at(t + 1, lane);
      v1 = valid_at(t + 1, 32 + lane);
    }
    unsigned long long mine = 0ULL;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (s == t / 32) mine = removed[s];
    cand &= ~__shfl_sync(full, mine, t % 32);

    // resolve the tile: a kept row removes the later rows it suppresses.
    // The 64 diagonal words go to registers first, so the chain of 64
    // decisions is register operations only.
    if (cand) {
      unsigned long long diag[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) diag[r] = rows[r * stride];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        if ((cand >> r) & 1ULL) cand &= ~diag[r];
    }
    if (i0 + lane < n) keep[start + i0 + lane] = (cand >> lane) & 1ULL;
    if (i0 + 32 + lane < n)
      keep[start + i0 + 32 + lane] = (cand >> (32 + lane)) & 1ULL;

    // the kept rows' words of the later tiles, OR'd into removed: per
    // slot 64 independent loads (a lane without a later tile reads a word
    // in range and drops it), then a select-and-OR over the kept bits
    if (cand) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if constexpr (!kStaged)
          if (32 * s + 31 <= t || 32 * s >= words) continue;
        const int ct = lane + 32 * s;
        const bool later = ct > t && ct < words;
        const unsigned long long* col = rows + (later ? ct - t : 0);
        unsigned long long acc[4] = {};
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const unsigned long long w = col[r * stride];
          acc[r % 4] |= (cand >> r) & 1ULL ? w : 0ULL;
        }
        if (later) removed[s] |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
      }
    }
    __syncwarp();  // buffer t & 1 is free for tile t + 2
  }
}

template <int SLOTS>
cudaError_t launch_scan(const void* valid, const void* table, int nseg,
                        const void* mask, void* keep, int tiles,
                        cudaStream_t s) {
  const int smem = SLOTS <= kMaxStagedSlots
                       ? 2 * kTile * tiles * static_cast<int>(sizeof(long long))
                       : 0;
  cudaError_t err = cudaFuncSetAttribute(
      nms3d_scan_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  nms3d_scan_kernel<SLOTS><<<nseg, 32, smem, s>>>(
      static_cast<const unsigned char*>(valid),
      static_cast<const long long*>(table), nseg,
      static_cast<const unsigned long long*>(mask),
      static_cast<unsigned char*>(keep));
  return cudaGetLastError();
}

}  // namespace

// boxes (total, 6) f32 and valid (total,) u8 (a bool tensor) are
// score-sorted within each segment.  table: (3, num_segments) i64, the
// segments' first rows, row counts and mask offsets; segment s holds rows
// [start_s, start_s + count_s) and its mask words from mask_off_s on,
// 64 * W_s * (W_s + 1) / 2 of them (W_s = ceil(count_s / 64)).  keep
// (total,) u8 (a bool tensor) out, per sorted row.  max_count <= 24576.
extern "C" int mrcnn3d_nms3d(const void* boxes, const void* valid,
                             const void* table, void* mask, void* keep,
                             int num_segments, int max_count, float thr,
                             void* stream) {
  if (num_segments <= 0 || max_count <= 0) return 0;
  const int tiles = (max_count + kTile - 1) / kTile;
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(tiles * (tiles + 1) / 2, num_segments);
  nms3d_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const long long*>(table),
      num_segments, static_cast<unsigned long long*>(mask), thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles <= 32)
    err = launch_scan<1>(valid, table, num_segments, mask, keep, tiles, s);
  else if (tiles <= 64)
    err = launch_scan<2>(valid, table, num_segments, mask, keep, tiles, s);
  else if (tiles <= 128)
    err = launch_scan<4>(valid, table, num_segments, mask, keep, tiles, s);
  else if (tiles <= 192)
    err = launch_scan<6>(valid, table, num_segments, mask, keep, tiles, s);
  else if (tiles <= 256)
    err = launch_scan<8>(valid, table, num_segments, mask, keep, tiles, s);
  else
    err = launch_scan<12>(valid, table, num_segments, mask, keep, tiles, s);
  return static_cast<int>(err);
}
