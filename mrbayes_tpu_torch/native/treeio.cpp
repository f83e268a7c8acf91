// Native .t-file tree parser: the host-side hot path of sumt/comparetree.
//
// The reference does its tree-sample summarization in C (DoSumt
// src/sumpt.c:4899 with the AVL split counters :2912); a pure-Python
// Newick parse of 10^4-10^5 sampled trees dominates sumt wall time, so
// this single-pass parser extracts, for every sampled tree, every edge's
// taxon-set bitmask and branch length directly from the file text.
// Canonicalization matches the Python side (summarize/sumt.py
// TreeSummary._norm): a mask containing tip 0 with more than one member
// is complemented.  Labels must be 1-based taxon numbers (the translate
// table form every .t writer uses — ours and the reference's).
//
// Build: g++ -O3 -shared -fPIC treeio.cpp -o _treeio.so (done on first
// import by mrbayes_tpu_torch/native/__init__.py).
#include <cstdlib>
#include <cstring>
#include <cstdint>

namespace {

struct Frame {
    uint64_t *mask;      // nwords
};

inline void or_into(uint64_t *dst, const uint64_t *src, int nwords) {
    for (int w = 0; w < nwords; ++w) dst[w] |= src[w];
}

inline int popcount_mask(const uint64_t *m, int nwords) {
    int c = 0;
    for (int w = 0; w < nwords; ++w) c += __builtin_popcountll(m[w]);
    return c;
}

}  // namespace

extern "C" {

// Parse every `tree <name> = [...] (...);` line in buf.
// Outputs (caller-allocated):
//   splits [max_trees * max_edges * nwords]  canonicalized edge masks
//   blens  [max_trees * max_edges]
//   nedges [max_trees]
//   rooted [max_trees]  (1 if the [&R] tag was seen)
// Returns the number of trees parsed, or -(byte offset) on parse error
// (the Python caller falls back to the pure-Python reader).
long mbt_parse_t(const char *buf, long n, int ntax, int nwords,
                 long max_trees, int max_edges,
                 uint64_t *splits, double *blens, int *nedges,
                 signed char *rooted) {
    long pos = 0;
    long ntrees = 0;
    const int max_depth = 2 * ntax + 4;
    uint64_t *stack = (uint64_t *)calloc((size_t)max_depth * nwords, 8);
    uint64_t *cur = (uint64_t *)calloc(nwords, 8);
    uint64_t *full = (uint64_t *)calloc(nwords, 8);
    if (!stack || !cur || !full) { free(stack); free(cur); free(full); return -1; }
    for (int i = 0; i < ntax; ++i) full[i >> 6] |= 1ULL << (i & 63);

    while (pos < n && ntrees < max_trees) {
        // find a line whose first token is "tree"
        long ls = pos;
        while (ls < n && (buf[ls] == ' ' || buf[ls] == '\t')) ++ls;
        bool is_tree = (ls + 4 < n && !strncmp(buf + ls, "tree", 4) &&
                        (buf[ls + 4] == ' ' || buf[ls + 4] == '\t'));
        // advance pos to next line start (done at the end of the loop)
        if (!is_tree) {
            while (pos < n && buf[pos] != '\n') ++pos;
            ++pos;
            continue;
        }
        long p = ls + 4;
        while (p < n && buf[p] != '=' && buf[p] != '\n') ++p;
        if (p >= n || buf[p] != '=') { pos = p + 1; continue; }
        ++p;
        signed char is_rooted = 0;
        // skip whitespace / [&U]-style comments
        for (;;) {
            while (p < n && (buf[p] == ' ' || buf[p] == '\t')) ++p;
            if (p < n && buf[p] == '[') {
                long c0 = p;
                while (p < n && buf[p] != ']') ++p;
                for (long q = c0; q < p; ++q)
                    if (buf[q] == '&' && q + 1 < p && buf[q + 1] == 'R')
                        is_rooted = 1;
                ++p;
            } else break;
        }
        if (p >= n || buf[p] != '(') {
            free(stack); free(cur); free(full);
            return -(p ? p : 1);
        }
        // iterative newick parse
        int depth = 0;
        int ne = 0;
        uint64_t *tsplits = splits + (long)ntrees * max_edges * nwords;
        double *tblens = blens + (long)ntrees * max_edges;
        bool have_cur = false;
        while (p < n && buf[p] != ';') {
            char c = buf[p];
            if (c == '(') {
                if (depth + 1 >= max_depth) goto fail;
                memset(stack + (size_t)depth * nwords, 0, (size_t)nwords * 8);
                ++depth;
                ++p;
            } else if (c == ',') {
                have_cur = false;
                ++p;
            } else if (c == ')') {
                --depth;
                if (depth < 0) goto fail;
                memcpy(cur, stack + (size_t)depth * nwords,
                       (size_t)nwords * 8);
                have_cur = true;
                ++p;
            } else if (c == ':') {
                ++p;
                char *endp;
                double b = strtod(buf + p, &endp);
                if (endp == buf + p) goto fail;
                p = endp - buf;
                if (!have_cur || ne >= max_edges) goto fail;
                // canonicalize: complement masks containing tip 0 with
                // more than one member
                uint64_t *out = tsplits + (size_t)ne * nwords;
                if ((cur[0] & 1ULL) && popcount_mask(cur, nwords) > 1) {
                    for (int w = 0; w < nwords; ++w)
                        out[w] = full[w] & ~cur[w];
                } else {
                    memcpy(out, cur, (size_t)nwords * 8);
                }
                tblens[ne] = b;
                ++ne;
                if (depth > 0)
                    or_into(stack + (size_t)(depth - 1) * nwords, cur,
                            nwords);
                have_cur = false;
            } else if (c >= '0' && c <= '9') {
                char *endp;
                long id = strtol(buf + p, &endp, 10);
                p = endp - buf;
                if (id < 1 || id > ntax) goto fail;
                memset(cur, 0, (size_t)nwords * 8);
                cur[(id - 1) >> 6] |= 1ULL << ((id - 1) & 63);
                have_cur = true;
            } else if (c == '[') {
                while (p < n && buf[p] != ']') ++p;
                ++p;
            } else if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
                ++p;
            } else {
                goto fail;   // named labels etc.: Python fallback
            }
            // a finished element with no ':' length still merges upward
            if (have_cur && p < n &&
                (buf[p] == ',' || buf[p] == ')' || buf[p] == ';')) {
                if (depth > 0)
                    or_into(stack + (size_t)(depth - 1) * nwords, cur,
                            nwords);
                have_cur = false;
            }
        }
        nedges[ntrees] = ne;
        rooted[ntrees] = is_rooted;
        ++ntrees;
        pos = p;
        while (pos < n && buf[pos] != '\n') ++pos;
        ++pos;
    }
    free(stack); free(cur); free(full);
    return ntrees;
fail:
    { long bad = pos; free(stack); free(cur); free(full);
      return bad > 0 ? -bad : -1; }
}

}  // extern "C"
