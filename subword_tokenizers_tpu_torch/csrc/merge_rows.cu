// K3p: apply one merge to the padded training state [n, L], in place.
//
// Replaces the JAX package's jitted XLA program
//   subword_tokenizers_tpu/ops/merge.py:19 apply_merge (inside train_steps,
//   ops/train_loop.py:129, the padded-layout K-step loop, and inside
//   sharded_apply_merge, parallel/train.py:409, on every shard),
// which marks matches with shifted copies, resolves self-merges by the
// parity of the offset in a run of equal symbols (a cummax), and compacts
// each row with a stable sort keyed on "is pad".
//
// Here a warp owns a row and reads it once, 32 columns at a time, each
// lane one column (coalesced); the next chunk is loaded before the current
// one is written, so the row is rewritten in place. In registers:
// - a match at column j is sym[j] == a and sym[j + 1] == b (the next
//   column by a shuffle; the chunk's last lane takes the next chunk's
//   first). For a != b that depends on no other column. For a == b only
//   the even offsets of a run of a match, the JAX rule: a ballot of the
//   columns that start a run of a, and each lane's nearest start at or
//   below it, give its offset; a run that goes on from the last chunk
//   carries the parity of its last offset;
// - the column after a match dies, PAD (-1) and negatives are dropped,
//   and each kept symbol's place is the count of kept ones before it (a
//   ballot and a population count, plus the count of earlier chunks);
// - a row changes from the first chunk with a match, a kept symbol out of
//   place, or a negative other than PAD; until then nothing is written,
//   so a row that holds no a (and no PAD inside) writes nothing. From
//   there every kept symbol is stored in its place, and the columns from
//   the last kept one to the row's last symbol become PAD.
// A row wider than 32 columns is taken in chunks with those carries, so
// any L works. (a, b, new_id) come from K2's record on the device
// (inactive: the rows are only compacted) or, under the mesh, from the
// host as the kernel's arguments.
//
// Bound on this card: memory traffic, every slot read once and the rows
// the merge changes written (2 MB read at train-85k's 22,971 x 22, a few
// hundred bytes written for a late merge), so a launch's latency bounds
// it; one launch takes every shard of a device.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

__global__ void merge_rows_kernel(int32_t* __restrict__ sym, int64_t n,
                                  int L, const int32_t* __restrict__ rec,
                                  int32_t a, int32_t b, int32_t new_id) {
  const int64_t r =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (r >= n) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  bool active = true;
  if (rec != nullptr) {
    active = rec[4] != 0;
    a = rec[0];
    b = rec[1];
    new_id = rec[2];
  }
  const bool self = a == b;
  int32_t* row = sym + r * L;
  int kept = 0;              // symbols kept in earlier chunks
  int last = -1;             // the last column holding other than PAD
  bool dirty = false;        // the row has changed by this chunk
  bool carry_match = false;  // the last chunk's last column matched,
  bool carry_a = false;      // held a,
  int carry_par = 0;         // at this parity of its offset in the run
  int32_t ahead = lane < L ? row[lane] : -1;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int j = c0 + lane;
    const int32_t s = ahead;
    ahead = j + 32 < L ? row[j + 32] : -1;
    int32_t nxt = __shfl_down_sync(kAll, s, 1);
    const int32_t head = __shfl_sync(kAll, ahead, 0);
    if (lane == 31) nxt = head;
    const bool is_a = active && s == a;
    bool match = is_a && nxt == b;
    if (self) {
      const unsigned m_a = __ballot_sync(kAll, is_a);
      const bool prev_a = lane ? (m_a >> (lane - 1)) & 1u : carry_a;
      const unsigned starts = __ballot_sync(kAll, is_a && !prev_a);
      const unsigned upto = starts & (kAll >> (31 - lane));
      const int par = upto ? (lane - (31 - __clz(upto))) & 1
                           : (carry_par + lane + 1) & 1;
      match = match && par == 0;
      carry_a = m_a >> 31;
      carry_par = __shfl_sync(kAll, par, 31);
    }
    const unsigned m_match = __ballot_sync(kAll, match);
    const bool dead = lane ? (m_match >> (lane - 1)) & 1u : carry_match;
    carry_match = m_match >> 31;
    const bool keep = s >= 0 && !dead;
    const unsigned m_keep = __ballot_sync(kAll, keep);
    const int to = kept + __popc(m_keep & ((1u << lane) - 1));
    const bool change = match || (keep && to != j) || (j < L && s < -1);
    dirty = __any_sync(kAll, change) || dirty;
    if (dirty && keep) row[to] = match ? new_id : s;
    kept += __popc(m_keep);
    const unsigned m_live = __ballot_sync(kAll, j < L && s != -1);
    if (m_live) last = c0 + 31 - __clz(m_live);
  }
  if (dirty)
    for (int k = kept + lane; k <= last; k += 32) row[k] = -1;
}

}  // namespace

extern "C" {

// sym i32[n, L] (rewritten in place); rec i32[6] (columns 0-4 read) or
// NULL, then the merge (a, b) -> new_id given by the host. n >= 1, L >= 1,
// n * L < 2^31. Returns the cudaError_t.
int swt_merge_rows(void* sym, int64_t n, int64_t L, const void* rec, int a,
                   int b, int new_id, void* stream) {
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  merge_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(sym), n, static_cast<int>(L),
      static_cast<const int32_t*>(rec), a, b, new_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
