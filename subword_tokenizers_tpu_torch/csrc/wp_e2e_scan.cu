// FastWP's end-to-end LinMaxMatch scan (kernel 1), in two forms that walk
// rows with one step machine (wp_scan_walk.cuh):
// - swt_wp_e2e_scan_{u16,i32}, the rows form: dense rows [S, cap], the
//   positions a row never wrote zero;
// - swt_wp_e2e_scan_compact_{u16,i32}: the same walk, then kernel 2's
//   tile epilogue (compact_tile.cuh) over the block's own rows in the same
//   launch, giving (ids, head) as compact.cu does from the rows form.
//
// Replaces the JAX package's jitted XLA programs
//   subword_tokenizers_tpu/ops/wp_encode_e2e.py: _wp_e2e_scan_impl
//     (reached through wp_e2e_scan and wp_e2e_scan_u16), and, in the
//     second form, wp_e2e_scan_u16_stacked / wp_e2e_scan_u16_fused (the
//     scan and the compaction in one device program);
//   subword_tokenizers_tpu/ops/wp_encode.py: wp_e2e_encode
//     (the general-pops route, in the rows form).
// The XLA programs step every row in lockstep inside a while_loop; here
// a thread walks its row until DONE or the step cap, its state in
// registers.
//
// A block takes a tile of consecutive rows, a thread a row:
// - the tile's char words are copied once into shared memory, 16-byte
//   loads in flight together (rows padded to an odd count of 4-byte
//   words, so lanes at one column hit distinct banks), and each step
//   reads its char word there;
// - a row writes only the tokens it emits, into its row of the tile's
//   token stage in shared memory; nothing is zero-filled;
// - the rows form then writes the tile's [rows, cap] block coalesced,
//   zeros at the positions no step wrote; the compact form finds the
//   tile's place in the stream by a look-back, copies the tile's emitted
//   prefixes as one stretch and writes the offsets and flags;
// - the block holds as many rows as fit (128, down to one warp: the
//   wrapper's rows_per_block and strides, ops/wp_encode_e2e.
//   tile_layout); rows too wide even for one warp's stage
//   read their chars from device memory and stage their tokens there
//   (the rows form in its output rows, the compact form in the caller's
//   [S, cap] scratch), the same code with another pointer.
// The compact form takes its tile from a ticket (compact_tile.cuh), so a
// tile's look-back waits only on blocks that already run.
//
// What bounds it on the card: the walk, not the bytes (train-85k's
// 27,482 unique chunks move 1.8 MB of chars in and 0.7 MB of tokens
// out). A step costs more while most rows run, likely the throughput of
// the warps' scattered gathers into the trie (20,840 nodes x 80 goto
// columns of i32 = 6.7 MB and 0.7 MB of records for the 8k vocab, in the
// 50 MB L2), than at the end, when the slowest rows' chain of dependent
// gathers, one a MATCH step, is left. The step is one path for every mode (wp_scan_walk.cuh):
// a switch ran each warp's modes one after another and was slower.

#include <cstdint>

#include <cuda_runtime.h>

#include "compact_tile.cuh"
#include "stage_rows.cuh"
#include "wp_scan_walk.cuh"

namespace {

constexpr int kWideRows = 128;  // a block's rows when nothing is staged

template <typename Word>
struct Rows {
  const Word* chars;  // [S, W]
  int64_t S, W;
  const int32_t* slen;
  int ws;  // a staged char row's stride, in words
  int st;  // a staged token row's stride
};

// Stages the tile's chars (kStaged), then walks this thread's row; its
// tokens go to stage[tid * stride + pos]. Every thread of the block calls
// it; rows past S do not walk.
template <typename Word, bool kStaged>
__device__ __forceinline__ RowEnd walk_tile(const Rows<Word>& r,
                                            const Trie& t, int64_t row0,
                                            int nrows, Word* s_chars,
                                            int32_t* stage, int64_t stride) {
  const int tid = threadIdx.x;
  const int W = static_cast<int>(r.W);
  if (kStaged) {
    stage_chars(r.chars + row0 * r.W, nrows, W, r.ws, s_chars);
    __syncthreads();
  }
  if (tid >= nrows) return {0, 0, false, false, false};
  const Word* row = kStaged ? s_chars + tid * r.ws
                            : r.chars + (row0 + tid) * r.W;
  int32_t* orow = stage + tid * stride;
  return walk_row(row, W, r.slen[row0 + tid], t,
                  [&](int pos, int32_t v) { orow[pos] = v; });
}

template <typename Word, bool kStaged>
__global__ void __launch_bounds__(kWideRows)
    scan_rows_kernel(const Rows<Word> r, const Trie t,
                     int32_t* __restrict__ out, int32_t* __restrict__ out_n,
                     uint8_t* __restrict__ ovf, uint8_t* __restrict__ stuck,
                     uint8_t* __restrict__ crash) {
  extern __shared__ __align__(16) int32_t s_dyn[];
  __shared__ int s_hi[kWideRows];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int nrows = static_cast<int>(
      r.S - row0 < blockDim.x ? r.S - row0 : blockDim.x);
  const int cap = t.cap;
  int32_t* stage = kStaged ? s_dyn : out + row0 * cap;
  const int64_t stride = kStaged ? r.st : cap;
  Word* s_chars = reinterpret_cast<Word*>(s_dyn + blockDim.x * r.st);
  const RowEnd e = walk_tile<Word, kStaged>(r, t, row0, nrows, s_chars,
                                            stage, stride);
  if (tid < nrows) {
    out_n[row0 + tid] = e.n;
    ovf[row0 + tid] = e.ovf;
    stuck[row0 + tid] = e.stuck;
    crash[row0 + tid] = e.crash;
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

template <typename Word, bool kStaged>
__global__ void __launch_bounds__(kWideRows)
    scan_compact_kernel(const Rows<Word> r, const Trie t,
                        int32_t* __restrict__ gstage, int32_t* ids,
                        int32_t* head, long long* scratch, unsigned epoch,
                        int n_tiles) {
  extern __shared__ __align__(16) int32_t s_dyn[];
  const int tile = take_tile(scratch, n_tiles);
  const int64_t row0 = static_cast<int64_t>(tile) * blockDim.x;
  const int nrows = static_cast<int>(
      r.S - row0 < blockDim.x ? r.S - row0 : blockDim.x);
  const int cap = t.cap;
  int32_t* stage = kStaged ? s_dyn : gstage + row0 * cap;
  const int64_t stride = kStaged ? r.st : cap;
  Word* s_chars = reinterpret_cast<Word*>(s_dyn + blockDim.x * r.st);
  const RowEnd e = walk_tile<Word, kStaged>(r, t, row0, nrows, s_chars,
                                            stage, stride);
  __syncthreads();  // the staged tokens are the block's
  compact_tile(tile, n_tiles, row0, nrows, r.S, cap, e.n,
               e.ovf | (e.stuck << 1) | (e.crash << 2), stage, stride, ids,
               head, tile_status(scratch), epoch);
}

template <typename Word>
int prepare(const void* chars, int64_t S, int64_t W, const void* slen,
            const void* goto_t, int64_t A1, const void* rec,
            const void* pops_flat, const void* sharp, int n_sharp,
            int root_p, int root_sharp, int unk_id, int cap, int max_steps,
            int unk_ovf, int rows_per_block, int ws, int st, Rows<Word>& r,
            Trie& t, size_t& smem, int& threads) {
  r = {static_cast<const Word*>(chars), S, W,
       static_cast<const int32_t*>(slen), ws, st};
  t = {static_cast<const int32_t*>(goto_t), A1,
       static_cast<const int4*>(rec), static_cast<const int32_t*>(pops_flat),
       static_cast<const int32_t*>(sharp), n_sharp, root_p, root_sharp,
       unk_id, cap, max_steps, unk_ovf};
  if (rows_per_block < 0 || rows_per_block > kWideRows ||
      rows_per_block % 32 || ws < W || st < cap)
    return static_cast<int>(cudaErrorInvalidValue);
  threads = rows_per_block ? rows_per_block : kWideRows;
  smem = rows_per_block
             ? static_cast<size_t>(rows_per_block) *
                   (r.st * sizeof(int32_t) + r.ws * sizeof(Word))
             : 0;
  return 0;
}

template <typename Word>
int launch_rows(const void* chars, int64_t S, int64_t W, const void* slen,
                const void* goto_t, int64_t A1, const void* rec,
                const void* pops_flat, const void* sharp, int n_sharp,
                int root_p, int root_sharp, int unk_id, int cap,
                int max_steps, int unk_ovf, int rows_per_block, int ws,
                int st, void* out, void* out_n, void* ovf, void* stuck,
                void* crash, void* stream) {
  Rows<Word> r;
  Trie t;
  size_t smem;
  int threads;
  int err = prepare<Word>(chars, S, W, slen, goto_t, A1, rec, pops_flat,
                          sharp, n_sharp, root_p, root_sharp, unk_id, cap,
                          max_steps, unk_ovf, rows_per_block, ws, st, r, t,
                          smem, threads);
  if (err) return err;
  const unsigned blocks = static_cast<unsigned>((S + threads - 1) / threads);
  const auto kernel = rows_per_block ? &scan_rows_kernel<Word, true>
                                     : &scan_rows_kernel<Word, false>;
  if ((err = allow_smem(kernel, smem))) return err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, t, static_cast<int32_t*>(out), static_cast<int32_t*>(out_n),
      static_cast<uint8_t*>(ovf), static_cast<uint8_t*>(stuck),
      static_cast<uint8_t*>(crash));
  return static_cast<int>(cudaGetLastError());
}

template <typename Word>
int launch_compact(const void* chars, int64_t S, int64_t W, const void* slen,
                   const void* goto_t, int64_t A1, const void* rec,
                   const void* pops_flat, const void* sharp, int n_sharp,
                   int root_p, int root_sharp, int unk_id, int cap,
                   int max_steps, int unk_ovf, int rows_per_block, int ws,
                   int st, void* gstage, void* ids, void* head,
                   void* scratch, int epoch, void* stream) {
  Rows<Word> r;
  Trie t;
  size_t smem;
  int threads;
  int err = prepare<Word>(chars, S, W, slen, goto_t, A1, rec, pops_flat,
                          sharp, n_sharp, root_p, root_sharp, unk_id, cap,
                          max_steps, unk_ovf, rows_per_block, ws, st, r, t,
                          smem, threads);
  if (err) return err;
  if (!rows_per_block && gstage == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (S + threads - 1) / threads;
  const auto kernel = rows_per_block ? &scan_compact_kernel<Word, true>
                                     : &scan_compact_kernel<Word, false>;
  if ((err = allow_smem(kernel, smem))) return err;
  kernel<<<static_cast<unsigned>(n_tiles), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      r, t, static_cast<int32_t*>(gstage), static_cast<int32_t*>(ids),
      static_cast<int32_t*>(head), static_cast<long long*>(scratch),
      static_cast<unsigned>(epoch), static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The rows form. chars: u16 words [S, W]; rec: int32 [n, 8] node records;
// rows_per_block: a multiple of 32 up to 128 whose staging fits shared
// memory, or 0 for rows staged in device memory; ws, st: the staged
// rows' strides (chars in words, tokens in int32; ops/wp_encode_e2e.
// tile_layout). Returns the cudaError_t of the launch.
int swt_wp_e2e_scan_u16(const void* chars, int64_t S, int64_t W,
                        const void* slen, const void* goto_t, int64_t A1,
                        const void* rec, const void* pops_flat,
                        const void* sharp, int n_sharp, int root_p,
                        int root_sharp, int unk_id, int cap, int max_steps,
                        int unk_ovf, int rows_per_block, int ws, int st,
                        void* out, void* out_n, void* ovf, void* stuck,
                        void* crash, void* stream) {
  return launch_rows<uint16_t>(chars, S, W, slen, goto_t, A1, rec, pops_flat,
                               sharp, n_sharp, root_p, root_sharp, unk_id,
                               cap, max_steps, unk_ovf, rows_per_block, ws,
                               st, out, out_n, ovf, stuck, crash, stream);
}

// The rows form over i32 words [S, W].
int swt_wp_e2e_scan_i32(const void* chars, int64_t S, int64_t W,
                        const void* slen, const void* goto_t, int64_t A1,
                        const void* rec, const void* pops_flat,
                        const void* sharp, int n_sharp, int root_p,
                        int root_sharp, int unk_id, int cap, int max_steps,
                        int unk_ovf, int rows_per_block, int ws, int st,
                        void* out, void* out_n, void* ovf, void* stuck,
                        void* crash, void* stream) {
  return launch_rows<int32_t>(chars, S, W, slen, goto_t, A1, rec, pops_flat,
                              sharp, n_sharp, root_p, root_sharp, unk_id,
                              cap, max_steps, unk_ovf, rows_per_block, ws,
                              st, out, out_n, ovf, stuck, crash, stream);
}

// The compact form over u16 words: ids i32[S * cap], head i32[2S + 1];
// gstage i32[S, cap] when rows_per_block is 0 (else null); scratch the
// ticket (0 between calls) and a 16-byte look-back word a tile; epoch
// in [1, 2^30), new a call. S >= 1.
int swt_wp_e2e_scan_compact_u16(
    const void* chars, int64_t S, int64_t W, const void* slen,
    const void* goto_t, int64_t A1, const void* rec, const void* pops_flat,
    const void* sharp, int n_sharp, int root_p, int root_sharp, int unk_id,
    int cap, int max_steps, int unk_ovf, int rows_per_block, int ws, int st,
    void* gstage, void* ids, void* head, void* scratch, int epoch,
    void* stream) {
  return launch_compact<uint16_t>(chars, S, W, slen, goto_t, A1, rec,
                                  pops_flat, sharp, n_sharp, root_p,
                                  root_sharp, unk_id, cap, max_steps,
                                  unk_ovf, rows_per_block, ws, st, gstage,
                                  ids, head, scratch, epoch, stream);
}

// The compact form over i32 words [S, W].
int swt_wp_e2e_scan_compact_i32(
    const void* chars, int64_t S, int64_t W, const void* slen,
    const void* goto_t, int64_t A1, const void* rec, const void* pops_flat,
    const void* sharp, int n_sharp, int root_p, int root_sharp, int unk_id,
    int cap, int max_steps, int unk_ovf, int rows_per_block, int ws, int st,
    void* gstage, void* ids, void* head, void* scratch, int epoch,
    void* stream) {
  return launch_compact<int32_t>(chars, S, W, slen, goto_t, A1, rec,
                                 pops_flat, sharp, n_sharp, root_p,
                                 root_sharp, unk_id, cap, max_steps, unk_ovf,
                                 rows_per_block, ws, st, gstage, ids, head,
                                 scratch, epoch, stream);
}

}  // extern "C"
