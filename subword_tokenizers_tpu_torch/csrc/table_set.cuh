// One row of a TableSet descriptor (ops/shard_select.py): a shard's K1
// table (pair_stats.cu) as the grouped kernels read it, the lookup and
// the compaction (shard_select.cu) and the nomination (nominate.cu).

#pragma once

#include <cstdint>

namespace {

struct Shard {
  const unsigned long long* keys;
  const int64_t* counts;
  const uint32_t* pos;
  int64_t T;     // entries, a power of two
  int64_t base;  // added to every position the shard reports
  int64_t flag;  // the compaction's overflow flag of the shard
};
static_assert(sizeof(Shard) == 6 * sizeof(int64_t), "descriptor row");

}  // namespace
