// Flags byte and dense token stream of a batch of scanned rows (kernel 2).
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/fetch.py: compact_ids, and
//   subword_tokenizers_tpu/ops/wp_encode_e2e.py: the tail of
//     wp_e2e_scan_u16_stacked (the flags byte and the compaction).
// The XLA programs write a u16 stream for the TPU's remote link; on the
// card the stream is i32 and in the caller's row order, which the host
// stitches by (offset, count).
//
// One launch over tiles of 256 rows (compact_tile.cuh): a block takes a
// tile from a ticket, reads its rows' counts and flags coalesced, scans
// the counts with warp shuffles, finds the tile's place in the stream by
// a decoupled look-back over the caller's scratch (epochs from the host,
// so nothing is cleared between calls), copies the tile's emitted
// prefixes (the tile's rows are contiguous in out, its tokens one
// stretch of the stream) and writes the offsets and flags; the last tile
// writes the total.
//
// Bound on this card: the bytes, each row's count and flags read and its
// offset and flags written, the emitted tokens read and written once;
// at the main path's shapes the look-back and the launch take longer.
//
// head (i32[2R+1]) = [offsets (R), total, flags (R)], so the host reads
// counts, flags and total with one copy.

#include <cstdint>

#include <cuda_runtime.h>

#include "compact_tile.cuh"

namespace {

constexpr int kTileRows = kMaxTileRows;

__global__ void __launch_bounds__(kTileRows)
    compact_rows_kernel(const int32_t* __restrict__ out, int64_t R, int cap,
                        const int32_t* __restrict__ out_n,
                        const uint8_t* __restrict__ ovf,
                        const uint8_t* __restrict__ stuck,
                        const uint8_t* __restrict__ crash, int32_t* ids,
                        int32_t* head, long long* scratch, unsigned epoch,
                        int n_tiles) {
  const int tile = take_tile(scratch, n_tiles);
  const int64_t row0 = static_cast<int64_t>(tile) * kTileRows;
  const int nrows =
      static_cast<int>(R - row0 < kTileRows ? R - row0 : kTileRows);
  const int64_t r = row0 + threadIdx.x;
  int n = 0, bits = 0;
  if (static_cast<int>(threadIdx.x) < nrows) {
    n = out_n[r];
    if (ovf) bits |= ovf[r] != 0;
    if (stuck) bits |= (stuck[r] != 0) << 1;
    if (crash) bits |= (crash[r] != 0) << 2;
  }
  compact_tile(tile, n_tiles, row0, nrows, R, cap, n, bits, out + row0 * cap,
               cap, ids, head, tile_status(scratch), epoch);
}

}  // namespace

extern "C" {

// out i32[R, cap], out_n i32[R], ovf/stuck/crash u8[R] (each may be null:
// false on every row) -> ids i32[R*cap], head i32[2R+1]; scratch: the
// ticket (0 between calls) and a 16-byte look-back word for each of the
// ceil(R / 256) tiles; epoch in [1, 2^30), new a call. R >= 1. Returns
// the cudaError_t of the launch.
int swt_compact(const void* out, int64_t R, int cap, const void* out_n,
                const void* ovf, const void* stuck, const void* crash,
                void* ids, void* head, void* scratch, int epoch,
                void* stream) {
  const int64_t n_tiles = (R + kTileRows - 1) / kTileRows;
  compact_rows_kernel<<<static_cast<unsigned>(n_tiles), kTileRows, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(out), R, cap,
      static_cast<const int32_t*>(out_n), static_cast<const uint8_t*>(ovf),
      static_cast<const uint8_t*>(stuck), static_cast<const uint8_t*>(crash),
      static_cast<int32_t*>(ids), static_cast<int32_t*>(head),
      static_cast<long long*>(scratch), static_cast<unsigned>(epoch),
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
