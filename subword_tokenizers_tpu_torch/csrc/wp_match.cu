// NaiveWP's greedy longest match (kernel 6), in two forms that walk words
// with one step machine (wp_match_walk.cuh):
// - swt_wp_match, the rows form: dense rows [W, L+4], the positions a row
//   never wrote zero;
// - swt_wp_match_compact: the same walk, then kernel 2's tile epilogue
//   (compact_tile.cuh) over the block's own rows in the same launch,
//   giving (ids, head) as compact.cu does from the rows form, the flags
//   byte ovf.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/wp_encode.py: wp_match_encode (the rows
//     form, with the [UNK] substitution), and wp_match_encode_stacked
//     (the matcher, the [UNK] substitution and compact_ids in one device
//     program: the compact form).
// The XLA program steps every word in lockstep inside a while_loop; here a
// thread walks its word until it is done or its step cap, its state in
// registers.
//
// A block takes a tile of consecutive words, a thread a word:
// - the tile's rows of alphabet ids are copied once into shared memory by
//   16-byte loads in flight together (stage_rows.cuh; rows at an odd
//   stride, so lanes at one column hit distinct banks), and the 17 jump
//   entries beside them;
// - a word writes only the tokens it emits, into its row of the tile's
//   token stage in shared memory; nothing is zero-filled;
// - the rows form then writes the tile's [rows, L+4] block coalesced,
//   zeros past what each row wrote; the compact form takes its tile from a
//   ticket, finds the tile's place in the stream by a look-back, copies
//   the tile's emitted prefixes as one stretch and writes the offsets and
//   flags;
// - the block holds as many words as fit (128, down to one warp: the
//   wrapper's rows_per_block and strides, ops/wp_encode_e2e.tile_layout);
//   words too wide even for one warp's stage read their ids from device
//   memory and stage their tokens there (the rows form in its output rows,
//   the compact form in the caller's [W, L+4] scratch), the same code with
//   another pointer.
//
// What bounds it on the card: the chain of dependent gathers of the
// slowest word, one 8-byte record a step, not the bytes (train-85k's
// 22,971 word types x 24 columns with the 8,000-token vocab: 2.2 MB of
// ids in, 0.6 MB of tokens out; 33.8 steps a word on average, the
// slowest word 181, 151 of them besides its '#' jumps). The records,
// 22,487 nodes x 80 columns x 8 bytes = 14.4 MB, sit in the 50 MB L2, and
// a word's deep nodes are its own, so each of those steps is an L2 round
// trip: on an H100 the slowest word alone takes 0.037 ms of the launch's
// 0.044.

#include <cstdint>

#include <cuda_runtime.h>

#include "compact_tile.cuh"
#include "stage_rows.cuh"
#include "wp_match_walk.cuh"

namespace {

constexpr int kWideRows = 128;  // a block's words when nothing is staged

struct Words {
  const int32_t* ids;  // [W, L] alphabet ids
  int64_t W, L;
  const int32_t* wlen;
  int ws;  // a staged id row's stride, in int32
  int st;  // a staged token row's stride
};

// Stages the tile's ids (kStaged) and the jump entries, then walks this
// thread's word; its tokens go to stage[tid * stride + pos]. Every thread
// of the block calls it; rows past W do not walk.
template <bool kStaged>
__device__ __forceinline__ WordEnd walk_tile(const Words& w,
                                             const MatchTables& t,
                                             int64_t row0, int nrows,
                                             int32_t* s_ids, int4* s_jump,
                                             int32_t* stage,
                                             int64_t stride) {
  const int tid = threadIdx.x;
  if (tid < kJumps) s_jump[tid] = t.jump[tid];
  if (kStaged)
    stage_chars(w.ids + row0 * w.L, nrows, static_cast<int>(w.L), w.ws,
                s_ids);
  __syncthreads();
  if (tid >= nrows) return {0, 0, false, false};
  const int32_t* word = kStaged ? s_ids + tid * w.ws
                                : w.ids + (row0 + tid) * w.L;
  int32_t* orow = stage + tid * stride;
  return walk_word(word, w.wlen[row0 + tid], t, s_jump,
                   [&](int pos, int32_t v) { orow[pos] = v; });
}

template <bool kStaged>
__global__ void __launch_bounds__(kWideRows)
    match_rows_kernel(const Words w, const MatchTables t,
                      int32_t* __restrict__ out, int32_t* __restrict__ out_n,
                      uint8_t* __restrict__ unk, uint8_t* __restrict__ ovf) {
  extern __shared__ __align__(16) int32_t s_dyn[];
  __shared__ int4 s_jump[kJumps];
  __shared__ int s_hi[kWideRows];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int nrows = static_cast<int>(
      w.W - row0 < blockDim.x ? w.W - row0 : blockDim.x);
  const int cap = t.cap;
  int32_t* stage = kStaged ? s_dyn : out + row0 * cap;
  const int64_t stride = kStaged ? w.st : cap;
  const WordEnd e = walk_tile<kStaged>(w, t, row0, nrows,
                                       s_dyn + blockDim.x * w.st, s_jump,
                                       stage, stride);
  if (tid < nrows) {
    out_n[row0 + tid] = e.n;
    unk[row0 + tid] = e.unk;
    ovf[row0 + tid] = e.ovf;
  }
  if (kStaged) {
    // the tile's rows, coalesced: zeros where no step wrote
    s_hi[tid] = e.hi;
    __syncthreads();
    int32_t* dst = out + row0 * cap;
    for (int q = tid; q < nrows * cap; q += blockDim.x) {
      const int j = q / cap;
      const int c = q - j * cap;
      dst[q] = c < s_hi[j] ? stage[j * stride + c] : 0;
    }
  } else if (tid < nrows) {
    for (int c = e.hi; c < cap; ++c) stage[tid * stride + c] = 0;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kWideRows)
    match_compact_kernel(const Words w, const MatchTables t,
                         int32_t* __restrict__ gstage, int32_t* ids,
                         int32_t* head, long long* scratch, unsigned epoch,
                         int n_tiles) {
  extern __shared__ __align__(16) int32_t s_dyn[];
  __shared__ int4 s_jump[kJumps];
  const int tile = take_tile(scratch, n_tiles);
  const int64_t row0 = static_cast<int64_t>(tile) * blockDim.x;
  const int nrows = static_cast<int>(
      w.W - row0 < blockDim.x ? w.W - row0 : blockDim.x);
  const int cap = t.cap;
  int32_t* stage = kStaged ? s_dyn : gstage + row0 * cap;
  const int64_t stride = kStaged ? w.st : cap;
  const WordEnd e = walk_tile<kStaged>(w, t, row0, nrows,
                                       s_dyn + blockDim.x * w.st, s_jump,
                                       stage, stride);
  __syncthreads();  // the staged tokens are the block's
  compact_tile(tile, n_tiles, row0, nrows, w.W, cap, e.n, e.ovf, stage,
               stride, ids, head, tile_status(scratch), epoch);
}

int prepare(const void* ids, int64_t W, int64_t L, const void* wlen,
            const void* rec, int64_t A1, const void* jump, int hash_aid,
            int cap, long long max_iter, int rows_per_block, int ws, int st,
            Words& w, MatchTables& t, size_t& smem, int& threads) {
  w = {static_cast<const int32_t*>(ids), W, L,
       static_cast<const int32_t*>(wlen), ws, st};
  t = {static_cast<const int2*>(rec), A1, static_cast<const int4*>(jump),
       hash_aid, cap, max_iter};
  if (rows_per_block < 0 || rows_per_block > kWideRows ||
      rows_per_block % 32 || ws < L || st < cap)
    return static_cast<int>(cudaErrorInvalidValue);
  threads = rows_per_block ? rows_per_block : kWideRows;
  smem = static_cast<size_t>(rows_per_block) * (st + ws) * sizeof(int32_t);
  return 0;
}

}  // namespace

extern "C" {

// The rows form. ids: i32 [W, L] alphabet ids; wlen: i32 [W]; rec: int2
// [n, A1] (child, accept[child]); jump: int4 [17]; rows_per_block: a
// multiple of 32 up to 128 whose staging fits shared memory, or 0 for
// words staged in device memory; ws, st: the staged rows' strides
// (ops/wp_encode_e2e.tile_layout). out: i32 [W, cap]; out_n: i32 [W];
// unk, ovf: u8 [W]. W >= 1, L >= 1. Returns the cudaError_t of the
// launch.
int swt_wp_match(const void* ids, int64_t W, int64_t L, const void* wlen,
                 const void* rec, int64_t A1, const void* jump, int hash_aid,
                 int cap, long long max_iter, int rows_per_block, int ws,
                 int st, void* out, void* out_n, void* unk, void* ovf,
                 void* stream) {
  Words w;
  MatchTables t;
  size_t smem;
  int threads;
  int err = prepare(ids, W, L, wlen, rec, A1, jump, hash_aid, cap, max_iter,
                    rows_per_block, ws, st, w, t, smem, threads);
  if (err) return err;
  const unsigned blocks = static_cast<unsigned>((W + threads - 1) / threads);
  const auto kernel = rows_per_block ? &match_rows_kernel<true>
                                     : &match_rows_kernel<false>;
  if ((err = allow_smem(kernel, smem))) return err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, t, static_cast<int32_t*>(out), static_cast<int32_t*>(out_n),
      static_cast<uint8_t*>(unk), static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

// The compact form: ids_out i32 [W * cap], head i32 [2W + 1]; gstage i32
// [W, cap] when rows_per_block is 0 (else null); scratch the ticket (0
// between calls) and a 16-byte look-back word a tile; epoch in [1, 2^30),
// new a call. The other arguments as swt_wp_match.
int swt_wp_match_compact(const void* ids, int64_t W, int64_t L,
                         const void* wlen, const void* rec, int64_t A1,
                         const void* jump, int hash_aid, int cap,
                         long long max_iter, int rows_per_block, int ws,
                         int st, void* gstage, void* ids_out, void* head,
                         void* scratch, int epoch, void* stream) {
  Words w;
  MatchTables t;
  size_t smem;
  int threads;
  int err = prepare(ids, W, L, wlen, rec, A1, jump, hash_aid, cap, max_iter,
                    rows_per_block, ws, st, w, t, smem, threads);
  if (err) return err;
  if (!rows_per_block && gstage == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (W + threads - 1) / threads;
  const auto kernel = rows_per_block ? &match_compact_kernel<true>
                                     : &match_compact_kernel<false>;
  if ((err = allow_smem(kernel, smem))) return err;
  kernel<<<static_cast<unsigned>(n_tiles), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      w, t, static_cast<int32_t*>(gstage), static_cast<int32_t*>(ids_out),
      static_cast<int32_t*>(head), static_cast<long long*>(scratch),
      static_cast<unsigned>(epoch), static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
