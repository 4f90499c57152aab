// The C++ walk of the traversal (reference semantics: AlignGraph.cpp:
// 1954-2204), frozen from aligngraph_tpu_torch/native/traverse.cpp at
// commit 5fa5dc4.  Inputs are the GraphTensors slot arrays (flat,
// C-order); outputs are pre-extended contig records + one concatenated
// sequence buffer.
//
// Build: g++ -O3 -shared -fPIC traverse.cpp -o libreftraverse.so

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t NONE = 0xFFFFFFFFu;

struct Arrays {
    int64_t n_pos;
    int S, K, E;
    const int8_t* base;
    const int8_t* cm_cnt;
    const uint32_t* cm_next;   // [P, S]
    const uint32_t* cm_nitem;  // [P, S]
    const int8_t* cm_base;     // [P, S]
    const uint32_t* cm_coff;   // [P, S] (unused by walk; kept for parity)
    const int8_t* km_cnt;
    uint8_t* km_trav;          // [P, K] (mutated)
    const uint32_t* km_coff;   // [P, K]
    const int32_t* km_votes;   // [P, K, 5]
    const uint32_t* km_s;      // [P, K]
    const int8_t* km_slen;     // [P, K]
    const uint32_t* km_mate;   // [P, K]
    const int8_t* ed_cnt;      // [P, K]
    const uint32_t* ed_pos;    // [P, K, E]
    const uint8_t* ed_item;    // [P, K, E]
};

struct Out {
    int8_t* seq_buf;
    int64_t seq_cap;
    int64_t seq_len;
    // per-contig records
    int64_t max_contigs;
    int64_t n_contigs;
    int64_t* seq_start;
    int64_t* seq_end;
    int32_t* extended;
    uint32_t* start_off;
    uint32_t* end_off;
    uint32_t* start0_id;
    uint32_t* start0_off;
    uint32_t* end0_id;
    uint32_t* end0_off;
    int overflow;
};

inline void push_base(Out& o, int8_t b) {
    if (o.seq_len < o.seq_cap) o.seq_buf[o.seq_len] = b;
    else o.overflow = 1;
    o.seq_len++;
}

// consensus with A>C>G>T>N tie priority; all-zero -> genome base
// (AlignGraph.cpp:1944-1952, 1997-2001)
inline int8_t consensus(const int32_t* v, int8_t genome_base) {
    if (!v[0] && !v[1] && !v[2] && !v[3] && !v[4]) return genome_base;
    int best = 0; int32_t bv = -1;
    for (int b = 0; b < 5; b++) if (v[b] > bv) { bv = v[b]; best = b; }
    return (int8_t)best;
}

inline bool contain(uint32_t s1, uint32_t so1, uint32_t e1, uint32_t eo1,
                    uint32_t s2, uint32_t so2, uint32_t e2, uint32_t eo2) {
    return s1 == s2 && e1 == e2 && so1 <= so2 && eo1 >= eo2;
}

}  // namespace

extern "C" int64_t ag_extd_contigs1(
    int64_t n_pos, int S, int K, int E,
    const int8_t* base,
    const int8_t* cm_cnt, const uint32_t* cm_next,
    const uint32_t* cm_nitem, const int8_t* cm_base,
    const uint32_t* cm_coff,
    const int8_t* km_cnt, uint8_t* km_trav, const uint32_t* km_coff,
    const int32_t* km_votes, const uint32_t* km_s, const int8_t* km_slen,
    const uint32_t* km_mate,
    const int8_t* ed_cnt, const uint32_t* ed_pos, const uint8_t* ed_item,
    int32_t coverage_unused, int32_t k_unused,
    int8_t* seq_buf, int64_t seq_cap,
    int64_t max_contigs,
    int64_t* seq_start, int64_t* seq_end, int32_t* extended_out,
    uint32_t* start_off, uint32_t* end_off,
    uint32_t* start0_id, uint32_t* start0_off,
    uint32_t* end0_id, uint32_t* end0_off,
    int64_t* seq_len_out) {
    Arrays a{n_pos, S, K, E, base, cm_cnt, cm_next, cm_nitem, cm_base,
             cm_coff, km_cnt, km_trav, km_coff, km_votes, km_s, km_slen,
             km_mate, ed_cnt, ed_pos, ed_item};
    Out o{seq_buf, seq_cap, 0, max_contigs, 0, seq_start, seq_end,
          extended_out, start_off, end_off, start0_id, start0_off,
          end0_id, end0_off, 0};

    uint32_t sidBak = NONE, soffBak = NONE, eidBak = NONE, eoffBak = NONE;
    int64_t cp = 0;
    while (cp < n_pos) {
        for (int ip = 0; ip < a.km_cnt[cp]; ip++) {
            if (a.km_trav[cp * K + ip]) continue;
            // ---- walk ----
            int64_t cpp = cp; int ipp = ip;
            int tag = 1;
            int ext = 0;
            int64_t seq_begin = o.seq_len;
            uint32_t st0 = a.km_mate[cp * K + ip];
            uint32_t s0id = (st0 != NONE) ? 0u : NONE;
            uint32_t sPack = 0; int sLen = 0;
            int64_t cppBak = cpp; int ippBak = ipp;

            while ((tag == 1 && !a.km_trav[cpp * K + ipp]) || tag == 0) {
                if (tag == 0) {
                    push_base(o, a.cm_base[cpp * S + ipp]);
                    ext = 1;
                } else {
                    push_base(o, consensus(&a.km_votes[(cpp * K + ipp) * 5],
                                           a.base[cpp]));
                    if (a.km_coff[cpp * K + ipp] != NONE) ext = 1;
                }
                if (tag == 1) {
                    a.km_trav[cpp * K + ipp] = 1;
                    sPack = a.km_s[cpp * K + ipp];
                    sLen = a.km_slen[cpp * K + ipp];
                    int nCount = 0, nxt = -1;
                    for (int e = 0; e < a.ed_cnt[cpp * K + ipp]; e++) {
                        uint32_t tp = a.ed_pos[(cpp * K + ipp) * E + e];
                        uint8_t ti = a.ed_item[(cpp * K + ipp) * E + e];
                        if (tp != NONE && !a.km_trav[(int64_t)tp * K + ti]) {
                            nCount++; nxt = e;
                        }
                    }
                    if (nCount == 1) {
                        cppBak = a.ed_pos[(cpp * K + ipp) * E + nxt];
                        ippBak = a.ed_item[(cpp * K + ipp) * E + nxt];
                        cpp = cppBak; ipp = ippBak; tag = 1;
                    } else if (a.cm_cnt[cpp] == 1 &&
                               a.cm_next[cpp * S] != NONE) {
                        cppBak = a.cm_next[cpp * S];
                        ippBak = (int)a.cm_nitem[cpp * S];
                        cpp = cppBak; ipp = ippBak; tag = 0;
                    } else {
                        tag = -1;
                    }
                } else {
                    if (a.cm_next[cpp * S + ipp] != NONE) {
                        cppBak = a.cm_next[cpp * S + ipp];
                        ippBak = (int)a.cm_nitem[cpp * S + ipp];
                        cpp = cppBak; ipp = ippBak; tag = 0;
                    } else {
                        int count = 0, item = -1;
                        for (int i3 = 0; i3 < a.km_cnt[cpp]; i3++)
                            if (!a.km_trav[cpp * K + i3]) { count++; item = i3; }
                        int nCount = 0, nxt = -1;
                        if (count == 1) {
                            for (int e = 0; e < a.ed_cnt[cpp * K + item]; e++) {
                                uint32_t tp = a.ed_pos[(cpp * K + item) * E + e];
                                uint8_t ti = a.ed_item[(cpp * K + item) * E + e];
                                if (tp != NONE &&
                                    !a.km_trav[(int64_t)tp * K + ti]) {
                                    nCount++; nxt = e;
                                }
                            }
                        }
                        if (nCount == 1) {
                            cppBak = a.ed_pos[(cpp * K + item) * E + nxt];
                            ippBak = a.ed_item[(cpp * K + item) * E + nxt];
                            cpp = cppBak; ipp = ippBak;
                            tag = a.km_trav[cpp * K + ipp] ? -2 : 1;
                        } else {
                            tag = -2;
                        }
                    }
                }
            }
            // ---- end coords (AlignGraph.cpp:2142-2173) ----
            uint32_t eOff, e0id, e0off;
            if (tag == 1) eOff = (uint32_t)cppBak;
            else eOff = (uint32_t)cpp;
            if (tag == 1 || tag == -1) {
                uint32_t m = a.km_mate[cpp * K + ipp];
                e0id = (m != NONE) ? 0u : NONE;
                e0off = m;
            } else { e0id = NONE; e0off = NONE; }
            if (tag == 1 || tag == -1) {
                if (sLen > 1) {
                    uint32_t p = sPack;
                    int8_t tmp[16];
                    for (int i = sLen - 1; i >= 0; i--) {
                        tmp[i] = (int8_t)(p & 7u); p >>= 3;
                    }
                    for (int i = 1; i < sLen; i++) push_base(o, tmp[i]);
                }
                int add = sLen > 0 ? sLen - 1 : 0;
                eOff = eOff + (uint32_t)add;
                e0off = e0off + (uint32_t)add;
            }
            // ---- contain-dedup vs previous output ----
            if (!contain(sidBak, soffBak, eidBak, eoffBak,
                         0u, (uint32_t)cp, 0u, eOff)) {
                if (o.n_contigs < o.max_contigs) {
                    int64_t n = o.n_contigs;
                    o.seq_start[n] = seq_begin;
                    o.seq_end[n] = o.seq_len;
                    o.extended[n] = ext;
                    o.start_off[n] = (uint32_t)cp;
                    o.end_off[n] = eOff;
                    o.start0_id[n] = s0id;
                    o.start0_off[n] = st0;
                    o.end0_id[n] = e0id;
                    o.end0_off[n] = e0off;
                } else {
                    o.overflow = 1;
                }
                o.n_contigs++;
                sidBak = 0u; soffBak = (uint32_t)cp;
                eidBak = 0u; eoffBak = eOff;
            } else {
                // contained output discarded: sequence bytes rolled back
                o.seq_len = seq_begin;
            }
        }
        // skip-ahead heuristic (AlignGraph.cpp:2194-2202)
        if (eidBak != NONE && (uint32_t)(eoffBak - soffBak) > 100000u) {
            if (eidBak == 0u && cp + 1000 < (int64_t)eoffBak) cp += 1000;
            else cp += 1;
        } else {
            cp += 1;
        }
    }
    *seq_len_out = o.seq_len;
    if (o.overflow) return -(o.n_contigs + 1);
    return o.n_contigs;
}
