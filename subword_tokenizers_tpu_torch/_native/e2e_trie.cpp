// FastWP's end-to-end trie (models/trie.E2ETrie) in one native pass: a
// Python list of vocabulary strings -> the trie's failure links, pops and
// its sorted-edge and dense transition tables.
//
// The tables equal those of the level-order build the JAX package writes
// in Python (subword_tokenizers_tpu/models/trie.py). "##" is inserted
// first, then each token in list order: node ids follow first insertion,
// and a node's children keep their first-insertion order, which sets the
// level order. root_p, a node with no edges, follows every inserted one.
// The level pass starts from the root, then "##"'s node (root_sharp), and
// skips root_sharp where it meets it as a child. An is_end child fails to
// root_sharp with one pop, its own token. Any other child walks its
// parent's failure chain, gathering the pops of the nodes it leaves, to
// the first node with an edge of its character: it fails along that edge
// and pops its parent's pops then the gathered ones; where the chain ends
// first it keeps no link and no pops. A child whose character is not
// alphanumeric (str.isalnum) then fails to root_p, keeping its pops.
//
// Pops are given as ranks: the k-th is_end node the level pass meets has
// rank k, and end_token[k] is the list index of the first token that ends
// there. The caller interns those tokens in rank order, which is the
// order the Python build interns them in, and maps ranks to output ids.
//
// GIL: swt_e2e_trie_build is bound with PYFUNCTYPE and reads the list's
// str objects under it; swt_e2e_trie_take touches no Python object.

#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int kCpBits = 21;
constexpr int64_t kMaxCp = 0x110000;

inline bool bit(const uint8_t* bits, uint32_t cp) {
  return (bits[cp >> 3] >> (7 - (cp & 7))) & 1;
}

struct Trie {
  // Per node. A node's children are a list in first-insertion order.
  std::vector<int32_t> first_child, last_child, next_sibling;
  std::vector<int32_t> cp;         // the edge's character into it, or -1
  std::vector<int32_t> end_token;  // list index of a token ending here
  std::vector<uint8_t> is_end;
  // Edges by (node << 21) | cp, open addressing; key -1 marks a free slot.
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  size_t mask = 0;

  int32_t root_sharp = -1, root_p = -1, n_alpha = 0;
  bool has_ws = false;
  std::vector<int32_t> fail, pops_off, pops_flat, alphabet;
  std::vector<int64_t> end_tok;  // by rank

  static size_t slot_of(int64_t key, size_t mask) {
    return static_cast<size_t>(
               (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) >> 20) &
           mask;
  }

  int32_t n_nodes() const { return static_cast<int32_t>(cp.size()); }

  int32_t find(int32_t node, int32_t c) const {
    const int64_t key = (static_cast<int64_t>(node) << kCpBits) | c;
    for (size_t i = slot_of(key, mask);; i = (i + 1) & mask) {
      if (keys[i] == key) return vals[i];
      if (keys[i] < 0) return -1;
    }
  }

  void put(int64_t key, int32_t val) {
    size_t i = slot_of(key, mask);
    while (keys[i] >= 0) i = (i + 1) & mask;
    keys[i] = key;
    vals[i] = val;
  }

  int32_t new_node(int32_t c) {
    first_child.push_back(-1);
    last_child.push_back(-1);
    next_sibling.push_back(-1);
    cp.push_back(c);
    end_token.push_back(-1);
    is_end.push_back(0);
    return n_nodes() - 1;
  }

  int32_t child(int32_t node, int32_t c) {
    const int32_t found = find(node, c);
    if (found >= 0) return found;
    const int32_t k = new_node(c);
    if (2 * static_cast<size_t>(k) > keys.size()) {
      std::vector<int64_t> old_keys(2 * keys.size(), -1);
      std::vector<int32_t> old_vals(2 * keys.size());
      old_keys.swap(keys);
      old_vals.swap(vals);
      mask = keys.size() - 1;
      for (size_t i = 0; i < old_keys.size(); ++i)
        if (old_keys[i] >= 0) put(old_keys[i], old_vals[i]);
    }
    put((static_cast<int64_t>(node) << kCpBits) | c, k);
    if (last_child[node] < 0)
      first_child[node] = k;
    else
      next_sibling[last_child[node]] = k;
    last_child[node] = k;
    return k;
  }

  Trie() : keys(1 << 12, -1), vals(1 << 12), mask((1 << 12) - 1) {
    new_node(-1);  // the root
  }

  void level_pass(const uint8_t* alnum_bits) {
    const int32_t n = n_nodes();
    fail.assign(n, -1);
    // Each node's pops, set once when the pass meets it, in an arena.
    std::vector<int32_t> arena, start(n, 0), len(n, 0), acc;
    std::vector<int32_t> queue{0, root_sharp};
    queue.reserve(n);
    for (size_t head = 0; head < queue.size(); ++head) {
      const int32_t cur = queue[head];
      for (int32_t ch = first_child[cur]; ch >= 0; ch = next_sibling[ch]) {
        if (ch == root_sharp) continue;
        const int32_t c = cp[ch];
        if (is_end[ch]) {
          fail[ch] = root_sharp;
          start[ch] = static_cast<int32_t>(arena.size());
          len[ch] = 1;
          arena.push_back(static_cast<int32_t>(end_tok.size()));
          end_tok.push_back(end_token[ch]);
        } else {
          int32_t f = fail[cur], to = -1;
          acc.clear();
          while (f >= 0) {
            to = find(f, c);
            if (to >= 0) break;
            acc.insert(acc.end(), arena.begin() + start[f],
                       arena.begin() + start[f] + len[f]);
            f = fail[f];
          }
          if (f >= 0) {
            fail[ch] = to;
            const int32_t s = static_cast<int32_t>(arena.size());
            for (int32_t j = 0; j < len[cur]; ++j) {
              const int32_t pop = arena[start[cur] + j];
              arena.push_back(pop);
            }
            arena.insert(arena.end(), acc.begin(), acc.end());
            start[ch] = s;
            len[ch] = static_cast<int32_t>(arena.size()) - s;
          }
        }
        if (!bit(alnum_bits, static_cast<uint32_t>(c))) fail[ch] = root_p;
        queue.push_back(ch);
      }
    }
    pops_off.assign(static_cast<size_t>(n) + 1, 0);
    pops_flat.reserve(arena.size());
    for (int32_t v = 0; v < n; ++v) {
      pops_flat.insert(pops_flat.end(), arena.begin() + start[v],
                       arena.begin() + start[v] + len[v]);
      pops_off[v + 1] = static_cast<int32_t>(pops_flat.size());
    }
  }
};

// Inserts word[0, len) of a str's PEP 393 buffer; returns its last node.
int32_t insert(Trie& t, int kind, const void* data, Py_ssize_t len) {
  int32_t node = 0;
  for (Py_ssize_t i = 0; i < len; ++i)
    node = t.child(node, static_cast<int32_t>(PyUnicode_READ(kind, data, i)));
  t.is_end[node] = 1;
  return node;
}

}  // namespace

extern "C" {

// Builds the trie of the str list vocab. Returns 0 and sets *out to a
// result that swt_e2e_trie_take copies out and frees, with sizes[0..7] =
// n_nodes, n_edges, n_alpha, n_pops, n_ends, root_sharp, root_p,
// has_ws_token; or returns -2, with *out null, when vocab is not a list of
// str. alnum_bits and ws_bits: the packed str.isalnum and str.isspace
// classes.
int64_t swt_e2e_trie_build(PyObject* vocab, const uint8_t* alnum_bits,
                           const uint8_t* ws_bits, void** out,
                           int64_t* sizes) {
  *out = nullptr;
  if (!PyList_Check(vocab)) return -2;
  const Py_ssize_t V = PyList_GET_SIZE(vocab);
  for (Py_ssize_t k = 0; k < V; ++k)
    if (!PyUnicode_Check(PyList_GET_ITEM(vocab, k))) return -2;
  Trie* t = new Trie();
  const uint32_t sharp[2] = {'#', '#'};
  t->root_sharp = insert(*t, PyUnicode_4BYTE_KIND, sharp, 2);
  for (Py_ssize_t k = 0; k < V; ++k) {
    PyObject* s = PyList_GET_ITEM(vocab, k);
    const int32_t node = insert(*t, PyUnicode_KIND(s), PyUnicode_DATA(s),
                                PyUnicode_GET_LENGTH(s));
    if (t->end_token[node] < 0) t->end_token[node] = static_cast<int32_t>(k);
  }
  t->root_p = t->new_node(-1);
  t->level_pass(alnum_bits);

  // Every node but the root and root_p has one edge in.
  const int32_t n = t->n_nodes();
  t->alphabet.assign(t->cp.begin() + 1, t->cp.end() - 1);
  std::sort(t->alphabet.begin(), t->alphabet.end());
  t->alphabet.erase(std::unique(t->alphabet.begin(), t->alphabet.end()),
                    t->alphabet.end());
  t->n_alpha = static_cast<int32_t>(t->alphabet.size());
  for (const int32_t c : t->alphabet)
    if (bit(ws_bits, static_cast<uint32_t>(c))) t->has_ws = true;
  sizes[0] = n;
  sizes[1] = n - 2;
  sizes[2] = t->n_alpha;
  sizes[3] = static_cast<int64_t>(t->pops_flat.size());
  sizes[4] = static_cast<int64_t>(t->end_tok.size());
  sizes[5] = t->root_sharp;
  sizes[6] = t->root_p;
  sizes[7] = t->has_ws;
  *out = t;
  return 0;
}

// Writes a result of swt_e2e_trie_build into edge_keys i64[n_edges]
// (sorted (node << 21) | cp) and edge_vals i32[n_edges], fail i32[n],
// pops_off i32[n + 1], pops_rank i32[n_pops], go i32[n, n_alpha + 1]
// (column n_alpha: no edge), alpha i32[0x110000] (codepoint -> alphabet
// id, n_alpha outside it) and end_token i64[n_ends], then frees it. With
// any of them null it only frees.
void swt_e2e_trie_take(void* result, int64_t* edge_keys, int32_t* edge_vals,
                       int32_t* fail, int32_t* pops_off, int32_t* pops_rank,
                       int32_t* go, int32_t* alpha, int64_t* end_token) {
  Trie* t = static_cast<Trie*>(result);
  if (edge_keys && edge_vals && fail && pops_off && pops_rank && go &&
      alpha && end_token) {
    const int32_t n = t->n_nodes();
    const size_t width = static_cast<size_t>(t->n_alpha) + 1;
    std::fill(alpha, alpha + kMaxCp, t->n_alpha);
    for (int32_t a = 0; a < t->n_alpha; ++a) alpha[t->alphabet[a]] = a;
    std::fill(go, go + width * static_cast<size_t>(n), -1);
    std::vector<std::pair<int32_t, int32_t>> kids;
    size_t e = 0;
    for (int32_t v = 0; v < n; ++v) {
      kids.clear();
      for (int32_t ch = t->first_child[v]; ch >= 0; ch = t->next_sibling[ch])
        kids.emplace_back(t->cp[ch], ch);
      std::sort(kids.begin(), kids.end());
      for (const auto& [c, ch] : kids) {
        edge_keys[e] = (static_cast<int64_t>(v) << kCpBits) | c;
        edge_vals[e++] = ch;
        go[width * static_cast<size_t>(v) + alpha[c]] = ch;
      }
    }
    std::memcpy(fail, t->fail.data(), sizeof(int32_t) * t->fail.size());
    std::memcpy(pops_off, t->pops_off.data(),
                sizeof(int32_t) * t->pops_off.size());
    std::memcpy(pops_rank, t->pops_flat.data(),
                sizeof(int32_t) * t->pops_flat.size());
    std::memcpy(end_token, t->end_tok.data(),
                sizeof(int64_t) * t->end_tok.size());
  }
  delete t;
}

}  // extern "C"
