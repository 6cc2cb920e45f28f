// Host columnar helpers of the file format and the external sort: the
// dictionary encoder of a string column read from a file, the payload
// gather that writes one, and the k-way merge of sorted spill runs.  The
// port's own copy of those three functions of the JAX package's
// native/fastcol.cpp, built beside concat.cpp into one library.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 concat.cpp fastcol.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// Dictionary-encodes n strings (bytes[offsets[i] .. offsets[i + 1]]; rows
// with valid[i] == 0 are NULL).  codes[i] is the row's index among the
// distinct values sorted bytewise (0 for NULL rows); dict_rows[j] is a row
// holding the j-th value.  Returns the number of distinct values.
// dict_rows must hold n entries.
int64_t dict_encode(const char* bytes, const int64_t* offsets, int64_t n,
                    const uint8_t* valid, int32_t* codes,
                    int64_t* dict_rows) {
  std::unordered_map<std::string_view, int32_t> first_row;
  first_row.reserve(static_cast<size_t>(n) * 2);
  std::vector<std::string_view> distinct;
  std::vector<int32_t> provisional(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) {
      provisional[i] = -1;
      continue;
    }
    std::string_view sv(bytes + offsets[i],
                        static_cast<size_t>(offsets[i + 1] - offsets[i]));
    auto it = first_row.find(sv);
    if (it == first_row.end()) {
      int32_t id = static_cast<int32_t>(distinct.size());
      first_row.emplace(sv, id);
      distinct.push_back(sv);
      provisional[i] = id;
      dict_rows[id] = i;
    } else {
      provisional[i] = it->second;
    }
  }
  int64_t n_distinct = static_cast<int64_t>(distinct.size());
  std::vector<int32_t> order(static_cast<size_t>(n_distinct));
  for (int64_t i = 0; i < n_distinct; ++i) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return distinct[a] < distinct[b];
  });
  std::vector<int32_t> rank(static_cast<size_t>(n_distinct));
  std::vector<int64_t> rows_sorted(static_cast<size_t>(n_distinct));
  for (int64_t i = 0; i < n_distinct; ++i) {
    rank[order[i]] = static_cast<int32_t>(i);
    rows_sorted[i] = dict_rows[order[i]];
  }
  std::memcpy(dict_rows, rows_sorted.data(),
              static_cast<size_t>(n_distinct) * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) {
    codes[i] = provisional[i] < 0 ? 0 : rank[provisional[i]];
  }
  return n_distinct;
}

// Concatenates the dictionary payload of each valid row's code into out,
// in row order (NULL rows add nothing).  out holds the sum of the rows'
// payload lengths, which the caller computes.
void gather_blob(const char* dict_bytes, const int64_t* dict_offsets,
                 const int32_t* codes, const uint8_t* valid, int64_t n,
                 char* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) continue;
    int32_t c = codes[i];
    int64_t len = dict_offsets[c + 1] - dict_offsets[c];
    std::memcpy(out + pos, dict_bytes + dict_offsets[c],
                static_cast<size_t>(len));
    pos += len;
  }
}

// Merges k sorted runs by their rows' code lanes (reference: the external
// sort's final merge, sort.cc:366-392).  codes: n_total x m row-major
// uint64 lanes whose ascending lexicographic order is the output order;
// starts: k + 1 offsets of the runs in the n_total rows; out: the n_total
// row ids in merged order.  Ties take the lower run first.
void kway_merge_u64(const uint64_t* codes, int64_t m, const int64_t* starts,
                    int64_t k, int64_t* out) {
  struct Head {
    const uint64_t* key;  // the current row's lanes
    int64_t row;          // its row id
    int64_t end;          // the run's end (exclusive)
    int32_t run;          // the run's ordinal (ties)
  };
  auto less = [m](const Head& a, const Head& b) {
    for (int64_t j = 0; j < m; ++j) {
      if (a.key[j] != b.key[j]) return a.key[j] < b.key[j];
    }
    return a.run < b.run;
  };
  std::vector<Head> heap;
  heap.reserve(static_cast<size_t>(k));
  auto sift_up = [&](size_t i) {
    while (i > 0) {
      size_t p = (i - 1) / 2;
      if (!less(heap[i], heap[p])) break;
      std::swap(heap[i], heap[p]);
      i = p;
    }
  };
  auto sift_down = [&](size_t i) {
    size_t n = heap.size();
    for (;;) {
      size_t l = 2 * i + 1, r = l + 1, best = i;
      if (l < n && less(heap[l], heap[best])) best = l;
      if (r < n && less(heap[r], heap[best])) best = r;
      if (best == i) break;
      std::swap(heap[i], heap[best]);
      i = best;
    }
  };
  for (int64_t run = 0; run < k; ++run) {
    if (starts[run] < starts[run + 1]) {
      heap.push_back(Head{codes + starts[run] * m, starts[run],
                          starts[run + 1], static_cast<int32_t>(run)});
      sift_up(heap.size() - 1);
    }
  }
  int64_t pos = 0;
  while (!heap.empty()) {
    Head& h = heap[0];
    out[pos++] = h.row;
    if (++h.row < h.end) {
      h.key += m;
      sift_down(0);
    } else {
      heap[0] = heap.back();
      heap.pop_back();
      if (!heap.empty()) sift_down(0);
    }
  }
}

}  // extern "C"
