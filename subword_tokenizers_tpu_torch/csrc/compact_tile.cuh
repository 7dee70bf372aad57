// Kernel 2's tile epilogue: a block's tile of consecutive rows written
// into the dense token stream, shared by compact.cu (rows read from the
// caller's [R, cap] tensor) and wp_e2e_scan.cu (rows the same block has
// just scanned, staged in shared memory).
//
// Semantics of the JAX package's ops/fetch.py: compact_ids and the tail
// of ops/wp_encode_e2e.py: wp_e2e_scan_u16_stacked:
// - a row's offset is the exclusive sum of the unclamped counts out_n;
// - a row copies min(out_n, cap) tokens; positions at or past R * cap
//   are dropped;
// - head (i32[2R + 1]) = [offsets (R), total, flags (R)], the flags byte
//   ovf | stuck<<1 | crash<<2 | sawneg2<<3, where sawneg2 marks a -2
//   ("'##' would hang") in the row's emitted prefix.
//
// A block's rows are contiguous in the source and their tokens one
// contiguous stretch of the stream: thread t copies the t-th stretch of
// the tile's emitted tokens (a binary search over the rows' clamped
// offsets in shared memory finds its first row). The tile's place in the
// stream comes from a decoupled look-back over a 16-byte status word a
// tile (lookback.cuh); the caller takes its tile index from a ticket, so
// a tile waits only on tiles whose blocks already run.

#pragma once

#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr int kMaxTileRows = 256;

// The tile's index from the ticket in scratch[0], which counts 0 ..
// n_tiles - 1 and is 0 again after the call's last tile.
__device__ __forceinline__ int take_tile(long long* scratch, int n_tiles) {
  __shared__ int s_tile;
  if (threadIdx.x == 0)
    s_tile = static_cast<int>(
        atomicInc(reinterpret_cast<unsigned*>(scratch), n_tiles - 1));
  __syncthreads();
  return s_tile;
}

// The look-back words, a 16-byte word a tile after the ticket's word.
__device__ __forceinline__ ulonglong2* tile_status(long long* scratch) {
  return reinterpret_cast<ulonglong2*>(scratch + 2);
}

// Every thread of the block calls it, thread j for the tile's row j
// (row0 + j; n = 0 and bits = 0 where j >= nrows). n: the row's
// unclamped count; bits: ovf | stuck<<1 | crash<<2; stage: row j's
// tokens at stage[j * stride + c], already visible to the block.
__device__ void compact_tile(int tile, int n_tiles, int64_t row0, int nrows,
                             int64_t R, int cap, int n, int bits,
                             const int32_t* stage, int64_t stride,
                             int32_t* __restrict__ ids,
                             int32_t* __restrict__ head, ulonglong2* status,
                             unsigned epoch) {
  __shared__ long long s_loc[kMaxTileRows];  // unclamped, exclusive
  __shared__ int s_mloc[kMaxTileRows + 1];   // clamped, exclusive
  __shared__ int s_neg[kMaxTileRows];
  __shared__ long long s_wn[kMaxTileRows / 32];
  __shared__ int s_wm[kMaxTileRows / 32];
  __shared__ long long s_base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // the rows' offsets in the tile: a warp scan, then the warps' sums
  long long sn = n;
  int sm = n < cap ? n : cap;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long un = __shfl_up_sync(~0u, sn, d);
    const int um = __shfl_up_sync(~0u, sm, d);
    if (lane >= d) {
      sn += un;
      sm += um;
    }
  }
  if (lane == 31) {
    s_wn[warp] = sn;
    s_wm[warp] = sm;
  }
  __syncthreads();
  long long tn = 0, before_n = 0;
  int tm = 0, before_m = 0;
  for (int w = 0; w < n_warps; ++w) {
    if (w == warp) {
      before_n = tn;
      before_m = tm;
    }
    tn += s_wn[w];
    tm += s_wm[w];
  }
  const long long xn = before_n + sn - n;
  s_loc[tid] = xn;
  s_mloc[tid] = before_m + sm - (n < cap ? n : cap);
  s_neg[tid] = 0;
  if (tid == 0) s_mloc[blockDim.x] = tm;

  // the tile's base in the stream
  if (warp == 0) {
    const long long agg = tn & 0xffffffffLL;
    if (lane == 0)
      publish2(status + tile, tile ? kAggregate : kInclusive, epoch, agg, 0);
    long long pre = 0, unused = 0;
    if (tile) {
      look_back_warp2(status, tile, epoch, pre, unused);
      if (lane == 0)
        publish2(status + tile, kInclusive, epoch,
                 (pre + agg) & 0xffffffffLL, 0);
    }
    if (lane == 0) {
      s_base = pre;
      if (tile == n_tiles - 1) head[R] = static_cast<int32_t>(pre + tn);
    }
  }
  __syncthreads();
  const long long base = s_base;
  if (tid < nrows) head[row0 + tid] = static_cast<int32_t>(base + xn);

  // the tile's tokens: thread t copies the t-th stretch of ceil(tm /
  // threads) of them, its first row found by a binary search over the
  // clamped offsets, the next ones by stepping on
  const long long lim = R * static_cast<long long>(cap);
  const int per = (tm + blockDim.x - 1) / blockDim.x;
  const int q0 = tid * per;
  const int q1 = q0 + per < tm ? q0 + per : tm;
  int j = 0, hi = nrows - 1;  // the last row j with s_mloc[j] <= q0
  while (j < hi) {
    const int mid = (j + hi + 1) >> 1;
    if (s_mloc[mid] <= q0) j = mid;
    else hi = mid - 1;
  }
  for (int q = q0; q < q1; ++q) {
    while (s_mloc[j + 1] <= q) ++j;
    const int c = q - s_mloc[j];
    const int32_t v = stage[j * stride + c];
    if (v == -2) s_neg[j] = 1;
    const long long d = base + s_loc[j] + c;
    if (d < lim) ids[d] = v;
  }
  __syncthreads();
  if (tid < nrows) head[R + 1 + row0 + tid] = bits | (s_neg[tid] << 3);
}

}  // namespace
