// Native host-side hot paths: CSR topology build and SNAP edge-list parsing.
//
// The host tier of the PyTorch/CUDA port, copied from the JAX package's
// tpu_cypher/native/csr_builder.cpp: the compute path stays on the card, but
// graph ingest (text -> edges) and topology compaction (edges -> CSR) are
// bandwidth-bound host loops where interpreter overhead dominates:
//
//  * parse_edge_list: single-pass scan of a SNAP-style buffer ('#' comments,
//    whitespace/comma separated int pairs) — replaces the per-line Python
//    loop in io/edge_list.py.
//  * build_csr: map raw int64 element ids to compact int32 indices (binary
//    search over the sorted unique id vector) and produce a CSR lexsorted by
//    (src, dst) via two stable counting sorts, O(E + N) — replaces
//    np.searchsorted + np.lexsort (O(E log E)) in CsrGraph.build.
//
// Exposed as a plain C ABI for ctypes (no pybind11, no PyTorch headers).
// Build (tpu_cypher_torch/native/__init__.py does it on first use, into
// tpu_cypher_torch/_build/):
//   g++ -O3 -shared -fPIC -std=c++17 csr_builder.cpp -o libcsr_builder.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Parse whitespace/comma-separated "src dst" pairs; skip '#...' comment and
// blank lines. Returns number of edges, or -(byte offset + 1) on malformed
// input. out_src/out_dst must have room for one edge per input line.
int64_t parse_edge_list(const char* buf, int64_t len,
                        int64_t* out_src, int64_t* out_dst) {
    int64_t count = 0;
    int64_t i = 0;
    while (i < len) {
        // skip leading spaces/commas
        while (i < len && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == ',' ||
                           buf[i] == '\r')) i++;
        if (i >= len) break;
        if (buf[i] == '\n') { i++; continue; }
        if (buf[i] == '#') {            // comment line
            while (i < len && buf[i] != '\n') i++;
            continue;
        }
        // parse two integers; each must be followed by a separator/EOL so
        // "2.5" or "2x" is rejected exactly like the Python loader's int()
        int64_t vals[2];
        for (int k = 0; k < 2; k++) {
            while (i < len && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == ','))
                i++;
            bool neg = false;
            if (i < len && (buf[i] == '-' || buf[i] == '+')) {
                neg = buf[i] == '-';
                i++;
            }
            if (i >= len || buf[i] < '0' || buf[i] > '9') return -(i + 1);
            int64_t v = 0;
            while (i < len && buf[i] >= '0' && buf[i] <= '9') {
                v = v * 10 + (buf[i] - '0');
                i++;
            }
            if (i < len && buf[i] != ' ' && buf[i] != '\t' && buf[i] != ',' &&
                buf[i] != '\r' && buf[i] != '\n')
                return -(i + 1);
            vals[k] = neg ? -v : v;
        }
        out_src[count] = vals[0];
        out_dst[count] = vals[1];
        count++;
        // skip to end of line (ignore trailing columns, e.g. weights)
        while (i < len && buf[i] != '\n') i++;
    }
    return count;
}

// Deduplicate + sort node ids in place semantics: input ids (n_in), output
// into out_ids; returns unique count. out_ids must have room for n_in.
int64_t unique_sorted(const int64_t* ids, int64_t n_in, int64_t* out_ids) {
    std::vector<int64_t> v(ids, ids + n_in);
    std::sort(v.begin(), v.end());
    auto end = std::unique(v.begin(), v.end());
    int64_t n = end - v.begin();
    std::memcpy(out_ids, v.data(), n * sizeof(int64_t));
    return n;
}

// Build CSR from compact-mapped edges.
//   node_ids: sorted unique int64 ids (n of them)
//   src/dst:  raw int64 endpoint ids (e of them); every id MUST be present
//             in node_ids (returns -1 otherwise)
//   row_ptr:  out, n+1 int32
//   col_idx:  out, e int32 (dst compact ids, lexsorted by (src, dst))
//   src_idx:  out, e int32 (src compact id per edge, sorted)
// Two stable counting sorts give the (src, dst) lexsort in O(E + N).
int32_t build_csr(const int64_t* node_ids, int64_t n,
                  const int64_t* src, const int64_t* dst, int64_t e,
                  int32_t* row_ptr, int32_t* col_idx, int32_t* src_idx) {
    // compact-map endpoints via binary search
    std::vector<int32_t> s(e), d(e);
    const int64_t* begin = node_ids;
    const int64_t* end = node_ids + n;
    for (int64_t i = 0; i < e; i++) {
        const int64_t* ps = std::lower_bound(begin, end, src[i]);
        const int64_t* pd = std::lower_bound(begin, end, dst[i]);
        if (ps == end || *ps != src[i] || pd == end || *pd != dst[i]) return -1;
        s[i] = (int32_t)(ps - begin);
        d[i] = (int32_t)(pd - begin);
    }
    // counting sort by dst (stable)
    std::vector<int64_t> cnt(n + 1, 0);
    std::vector<int32_t> s1(e), d1(e);
    for (int64_t i = 0; i < e; i++) cnt[d[i] + 1]++;
    for (int64_t i = 0; i < n; i++) cnt[i + 1] += cnt[i];
    {
        std::vector<int64_t> pos(cnt.begin(), cnt.end());
        for (int64_t i = 0; i < e; i++) {
            int64_t p = pos[d[i]]++;
            s1[p] = s[i];
            d1[p] = d[i];
        }
    }
    // stable counting sort by src -> final lexsort (src, dst)
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t i = 0; i < e; i++) cnt[s1[i] + 1]++;
    for (int64_t i = 0; i < n; i++) cnt[i + 1] += cnt[i];
    for (int64_t i = 0; i <= n; i++) row_ptr[i] = (int32_t)cnt[i];
    {
        std::vector<int64_t> pos(cnt.begin(), cnt.end());
        for (int64_t i = 0; i < e; i++) {
            int64_t p = pos[s1[i]]++;
            col_idx[p] = d1[i];
            src_idx[p] = s1[i];
        }
    }
    return 0;
}

// Stamped 2-hop DISTINCT-endpoints count: the host-tier replacement for
// materialize-20M-rows-then-sort (engine analog of a merge-free boolean
// SpGEMM row count). One pass over the path space with an O(N) timestamp
// array that lives in cache: stamp[c] == a marks pair (a, c) as seen.
// PRECONDITION (checked by the ctypes wrapper): equal akeys are contiguous
// (each source one run), so a stamp from an earlier source can never be
// confused with the current one.
//   rp1/ci1: hop-1 CSR (frontier -> b), rp2/ci2: hop-2 CSR (b -> c)
//   frontier/akeys: compact position + distinct-group key per input row
//   mask1/mask2: optional bool masks on b / c (null = unrestricted)
//   use_a/use_c: which endpoints the DISTINCT covers
int64_t two_hop_distinct(const int32_t* rp1, const int32_t* ci1,
                         const int32_t* rp2, const int32_t* ci2,
                         const int64_t* frontier, const int64_t* akeys,
                         int64_t nf, int64_t n, int32_t use_a, int32_t use_c,
                         const uint8_t* mask1, const uint8_t* mask2) {
    std::vector<int64_t> stamp(n, -1);
    int64_t cnt = 0;
    int64_t last_counted_a = -1;
    for (int64_t i = 0; i < nf; i++) {
        int64_t a = use_a ? akeys[i] : 0;  // !use_a: one global dedup group
        if (!use_c && use_a && a == last_counted_a) continue;
        int64_t p = frontier[i];
        bool found = false;
        for (int32_t e1 = rp1[p]; e1 < rp1[p + 1] && !(found && !use_c); e1++) {
            int32_t b = ci1[e1];
            if (mask1 && !mask1[b]) continue;
            for (int32_t e2 = rp2[b]; e2 < rp2[b + 1]; e2++) {
                int32_t c = ci2[e2];
                if (mask2 && !mask2[c]) continue;
                if (!use_c) { found = true; break; }
                if (stamp[c] != a) {
                    stamp[c] = a;
                    cnt++;
                }
            }
        }
        if (!use_c && found) {
            cnt++;
            last_counted_a = a;
        }
    }
    return cnt;
}

// Stamped 2-hop + ExpandInto close count (directed triangles / 2-hop
// cycles): per source a, pre-stamp the closing endpoints x reachable by a
// closing edge (rpc/cic = the close CSR oriented FROM a) with their edge
// multiplicities, then every surviving 2-hop path (a, b, c) adds the
// multiplicity of closing edges at c. Matches the searchsorted probe's
// hi-lo semantics exactly, parallel edges included. Same grouped-akeys
// precondition as two_hop_distinct.
int64_t two_hop_close_count(const int32_t* rp1, const int32_t* ci1,
                            const int32_t* rp2, const int32_t* ci2,
                            const int32_t* rpc, const int32_t* cic,
                            const int64_t* frontier, const int64_t* akeys,
                            int64_t nf, int64_t n,
                            const uint8_t* mask1, const uint8_t* mask2) {
    std::vector<int64_t> stamp(n, -1);
    std::vector<int32_t> mult(n, 0);
    int64_t cnt = 0;
    int64_t stamped_a = -1;
    for (int64_t i = 0; i < nf; i++) {
        int64_t a = akeys[i];
        if (a != stamped_a) {
            for (int32_t e = rpc[a]; e < rpc[a + 1]; e++) {
                int32_t x = cic[e];
                if (stamp[x] != a) {
                    stamp[x] = a;
                    mult[x] = 0;
                }
                mult[x]++;
            }
            stamped_a = a;
        }
        int64_t p = frontier[i];
        for (int32_t e1 = rp1[p]; e1 < rp1[p + 1]; e1++) {
            int32_t b = ci1[e1];
            if (mask1 && !mask1[b]) continue;
            for (int32_t e2 = rp2[b]; e2 < rp2[b + 1]; e2++) {
                int32_t c = ci2[e2];
                if (mask2 && !mask2[c]) continue;
                if (stamp[c] == a) cnt += mult[c];
            }
        }
    }
    return cnt;
}

// Bounded var-length walk count with relationship-distinctness (openCypher
// path isomorphism): iterative DFS per frontier row over the CSR, counting
// walks of length in [lo, hi] whose far node passes the label mask. The
// walked-edge stack holds canonical scan rows (eo) — undirected walks share
// one scan row per relationship, so reuse checks are direction-agnostic —
// and is at most `hi` deep, so the distinctness check is a linear scan of a
// register-resident array. Replaces materializing every partial-walk level
// on host backends (the device frontier loop keeps TPU/mesh paths).
int64_t varlen_count_forbid(const int32_t* rp, const int32_t* ci,
                            const int64_t* eo, const int64_t* frontier,
                            int64_t nf, int64_t lo, int64_t hi,
                            const uint8_t* far_mask,
                            const int64_t* forbid, int64_t nfb);

int64_t varlen_count(const int32_t* rp, const int32_t* ci, const int64_t* eo,
                     const int64_t* frontier, int64_t nf,
                     int64_t lo, int64_t hi, const uint8_t* far_mask) {
    return varlen_count_forbid(rp, ci, eo, frontier, nf, lo, hi, far_mask,
                               nullptr, 0);
}

// varlen_count with per-frontier-row forbidden edges: forbid is row-major
// [nf x nfb] canonical scan rows (-1 = unconstrained) that row i's walks may
// not use — the openCypher isomorphism between a var-length and the fixed
// relationships already bound in its input row (the device tier seeds the
// same values into the walked-edge masks).
int64_t varlen_count_forbid(const int32_t* rp, const int32_t* ci,
                            const int64_t* eo, const int64_t* frontier,
                            int64_t nf, int64_t lo, int64_t hi,
                            const uint8_t* far_mask,
                            const int64_t* forbid, int64_t nfb) {
    if (hi < 1 || hi > 64 || nfb < 0) return -1;  // caller falls back
    int64_t count = 0;
    std::vector<int64_t> estack(hi + 1);
    std::vector<int32_t> vstack(hi + 1);
    std::vector<int32_t> epos(hi + 1);
    for (int64_t i = 0; i < nf; i++) {
        int32_t s = (int32_t)frontier[i];
        const int64_t* fb = forbid ? forbid + i * nfb : nullptr;
        int depth = 0;
        vstack[0] = s;
        epos[0] = rp[s];
        while (depth >= 0) {
            if (epos[depth] < rp[vstack[depth] + 1]) {
                int32_t e = epos[depth]++;
                int64_t orig = eo[e];
                bool dup = false;
                for (int64_t k = 0; k < nfb; k++)
                    if (fb[k] == orig) { dup = true; break; }
                if (!dup)
                    for (int k = 0; k < depth; k++)
                        if (estack[k] == orig) { dup = true; break; }
                if (dup) continue;
                int32_t nb = ci[e];
                int d1 = depth + 1;
                if (d1 >= lo && (!far_mask || far_mask[nb])) count++;
                if (d1 < hi) {
                    estack[depth] = orig;
                    vstack[d1] = nb;
                    epos[d1] = rp[nb];
                    depth = d1;
                }
            } else {
                depth--;
            }
        }
    }
    return count;
}

}  // extern "C"
