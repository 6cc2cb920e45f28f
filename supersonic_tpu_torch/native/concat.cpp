// Host byte assembly of the CONCAT aggregation (reference: the per-group
// loop of AggregationOperator<CONCAT>, aggregation_operators.h:235-283).
// Its strings are variable-length, so the device computes the grouping and
// the host joins each group's payloads, as the reference does row by row.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 concat.cpp -o libconcat.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Joins the payloads of each group's valid rows with `sep`, in row order.
// Two passes: with out_bytes == nullptr it writes each group's length into
// out_lens (-1 for a group without a valid row, whose result is NULL) and
// returns the total byte count; called again with a buffer of that size,
// it fills the buffer.  codes: n int32 payload indices, rows grouped;
// valid: n byte-bools (nullptr: all valid); group_starts: g + 1 row
// offsets; distinct: each payload index at most once a group.
int64_t concat_groups(const char* dict_bytes, const int64_t* dict_offsets,
                      const int32_t* codes, const uint8_t* valid,
                      const int64_t* group_starts, int64_t g,
                      const char* sep, int64_t sep_len, uint8_t distinct,
                      int64_t* out_lens, char* out_bytes) {
  int64_t total = 0;
  std::vector<char> seen;  // per-group marks over payload indices
  for (int64_t gi = 0; gi < g; ++gi) {
    int64_t len = 0;
    bool first = true;
    if (distinct) seen.assign(seen.size(), 0);
    for (int64_t r = group_starts[gi]; r < group_starts[gi + 1]; ++r) {
      if (valid != nullptr && !valid[r]) continue;
      const int32_t c = codes[r];
      if (distinct) {
        if (static_cast<size_t>(c) >= seen.size()) seen.resize(c + 1, 0);
        if (seen[c]) continue;
        seen[c] = 1;
      }
      const int64_t vlen = dict_offsets[c + 1] - dict_offsets[c];
      if (!first) {
        if (out_bytes != nullptr)
          std::memcpy(out_bytes + total + len, sep, sep_len);
        len += sep_len;
      }
      if (out_bytes != nullptr)
        std::memcpy(out_bytes + total + len, dict_bytes + dict_offsets[c],
                    vlen);
      len += vlen;
      first = false;
    }
    if (out_lens != nullptr) out_lens[gi] = first ? -1 : len;
    total += len;
  }
  return total;
}

}  // extern "C"
