// Native graph-threading engine (C++ twin of engine/threading.py).
//
// The device DFA fast path resolves clean walks on-device; reads needing
// error correction fall back to the host.  This engine makes that
// fallback run at C++ speed.  Semantics mirror the (golden-verified)
// Python implementation exactly: same hypothesis scoring, k-mer/CIGAR
// surgery, uint64 nskip wrap, homopolymer/N handling and output strings.
//
// Exposed via ctypes:
//   dtk_graph_new/add/free  : per-locus node->edge-mask map
//   dtk_thread_read         : run isThreadFeasible on one read; returns
//                             status and fills cigar/annot strings + the
//                             corrected k-mer stream
//   dtk_thread_pairs        : BATCH entry — walk every fallback pair of
//                             a device step in one call (internal worker
//                             threads), count corrected k-mers into
//                             per-locus CountMaps, and emit ready RLE
//                             cigar/annot strings.  Removes the
//                             per-pair ctypes + Python list/dict costs
//                             that capped threading-mode e2e.
//   dtk_counts_new/size/drain/free : deferred per-locus count maps,
//                             drained into the Python tr_counts at
//                             checkpoint/finalize boundaries (adds
//                             commute, so batching order is free).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using std::string;
using std::vector;

typedef std::unordered_map<uint64_t, uint8_t> Graph;

const uint64_t NAN64 = 0xFFFFFFFFFFFFFFFFULL;
const int MSC = 5;

const uint8_t B2N[256] = {
#define X 255
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,0,X,1,X,X,X,2,X,X,X,X,X,X,X,X, X,X,X,X,3,X,X,X,X,X,X,X,X,X,X,X,
    X,0,X,1,X,X,X,2,X,X,X,X,X,X,X,X, X,X,X,X,3,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
#undef X
};
const char ALPHA[5] = "ACGT";

inline char comp_nt(char c) {
    switch (c) {
        case 'A': return 'T';
        case 'C': return 'G';
        case 'G': return 'C';
        case 'T': return 'A';
        default: return c;
    }
}

uint64_t nu_rc(uint64_t km, uint64_t k) {
    uint64_t rc = 0;
    for (uint64_t i = 0; i < k; ++i) {
        rc = (rc << 2) | (3 - (km & 3));
        km >>= 2;
    }
    return rc;
}

inline uint64_t to_ca(uint64_t km, uint64_t k) {
    uint64_t rc = nu_rc(km, k);
    return km < rc ? km : rc;
}

void read2kmers_nc(const string& seq, uint64_t k, vector<uint64_t>& out) {
    out.clear();
    int64_t n = (int64_t)seq.size() - (int64_t)k + 1;
    if (n <= 0) return;
    vector<uint64_t> tmp(n, NAN64);
    bool any = false;
    uint64_t km = 0;
    int run = 0;
    for (size_t i = 0; i < seq.size(); ++i) {
        uint8_t b = B2N[(uint8_t)seq[i]];
        if (b == 255) {
            run = 0;
            km = 0;
            continue;
        }
        km = ((km << 2) | b) & ((k < 32 ? (1ULL << 2 * k) : 0) - 1);
        if (++run >= (int)k) {
            tmp[i - k + 1] = km;
            any = true;
        }
    }
    if (any) out.swap(tmp);
}

struct Cigar {
    int ni = 0;
    // es entries: type char, read char, graph char
    vector<char> et, er, eg;
    vector<char> tr;

    void init(const string& seq, uint64_t k) {
        ni = 0;
        size_t n = seq.size();
        et.assign(n, '*');
        er.assign(seq.begin(), seq.end());
        eg.assign(n, 0);
        tr.assign(n >= k ? n - k + 1 : 0, '*');
    }
};

struct ThreadState {
    vector<uint64_t>* kmers;
    uint64_t ksize;
    uint64_t rmask;
    int64_t ki = 0;
    int64_t nskip = 0;   // tracked signed; compared as uint64 (wrap)
    int64_t ncorrection = 0;
};

inline bool nskip_gt(int64_t nskip, int64_t maxnskip) {
    return (uint64_t)nskip > (uint64_t)maxnskip;
}

struct ThreadExt {
    bool rv;
    uint64_t nem1[4] = {}, nem2[16] = {}, nemi[4] = {}, nemd[16] = {};
    uint64_t ned1[4] = {}, ned2[16] = {};
    uint64_t nei1 = 0, nei2 = 0;
    int mes;
    uint64_t ms1 = MSC, ms2 = 2 * MSC;
    uint64_t score = 0;
    int64_t nrk = 0;
    int64_t nm = 0, nd = 0, ni = 0;
    int64_t dt_km = 0;
    // edits: type, graph char
    vector<std::pair<char, char>> edits;

    ThreadExt(int mes_, bool rv_) : rv(rv_), mes(mes_) {}

    bool get_edit() {
        for (int i = 0; i < 4; ++i)
            if (nem1[i] > score && nem1[i] >= ms1) {
                score = nem1[i];
                edits = {{'X', ALPHA[i]}};
            }
        for (int i = 0; i < 4; ++i)
            if (ned1[i] > score && ned1[i] >= ms1) {
                score = ned1[i];
                edits = {{'D', ALPHA[i]}};
            }
        if (nei1 > score && nei1 >= ms1) {
            score = nei1;
            edits = {{'I', 0}};
        }
        if (mes > 1) {
            for (int i = 0; i < 4; ++i) {
                for (int j = 0; j < 4; ++j) {
                    uint64_t sm2 = nem2[i * 4 + j];
                    uint64_t smd = nemd[i * 4 + j];
                    uint64_t sd2 = ned2[i * 4 + j];
                    if (sm2 > score && sm2 >= ms2) {
                        score = sm2;
                        edits = {{'X', ALPHA[i]}, {'X', ALPHA[j]}};
                    }
                    if (smd > score && smd >= ms2) {
                        score = smd;
                        edits = {{'X', ALPHA[i]}, {'D', ALPHA[j]}};
                    }
                    if (sd2 > score && sd2 >= ms2) {
                        score = sd2;
                        edits = {{'D', ALPHA[i]}, {'D', ALPHA[j]}};
                    }
                }
                if (nemi[i] > score && nemi[i] >= ms2) {
                    score = nemi[i];
                    edits = {{'X', ALPHA[i]}, {'I', 0}};
                }
            }
            if (nei2 > score && nei2 >= ms2) {
                score = nei2;
                edits = {{'I', 0}, {'I', 0}};
            }
        }
        return score > 0;
    }

    void edit_kmers_forward(ThreadState& st, Cigar& cg,
                            const Graph& trK);
    void edit_kmers_backward(ThreadState& st, Cigar& cg,
                             const Graph& trK);
};

// trK doubles as the TR kmer "set" (canonical kmer -> anything)
inline bool in_tr(const Graph& trK, uint64_t ca) {
    return trK.count(ca) != 0;
}

void ThreadExt::edit_kmers_forward(ThreadState& st, Cigar& cg,
                                   const Graph& trK) {
    auto& kmers = *st.kmers;
    uint64_t k = st.ksize;
    uint64_t rmask = st.rmask;
    size_t n0 = kmers.size() - st.ki;
    vector<char> good(n0);
    vector<uint64_t> nts(n0);
    for (size_t i = 0; i < n0; ++i) {
        good[i] = kmers[st.ki + i] != NAN64;
        nts[i] = kmers[st.ki + i] & 3;
    }
    for (auto& e : edits) {
        if (e.first == 'X') {
            kmers[st.ki] = ((kmers[st.ki - 1] & rmask) << 2)
                + B2N[(uint8_t)e.second];
            ++st.ki;
            ++nm;
        } else if (e.first == 'D') {
            kmers.insert(kmers.begin() + st.ki, 0);
            kmers[st.ki] = ((kmers[st.ki - 1] & rmask) << 2)
                + B2N[(uint8_t)e.second];
            ++st.ki;
            ++nd;
        } else {
            kmers.erase(kmers.begin() + st.ki);
            ++ni;
        }
    }
    int64_t dt_nti = nm + ni;
    int64_t dt_ki = nm + nd;
    dt_km = nd - ni;
    int64_t i = st.ki;
    while (i < (int64_t)std::min<uint64_t>(kmers.size(), st.ki + k)) {
        if (!good[dt_nti]) break;
        kmers[i] = ((kmers[i - 1] & rmask) << 2) + nts[dt_nti];
        ++dt_nti;
        ++i;
    }
    if (dt_km > 0) cg.tr.insert(cg.tr.end(), dt_km, '*');
    else if (dt_km < 0) cg.tr.resize(cg.tr.size() + dt_km);
    for (int64_t j = 0; j < nd; ++j) {
        size_t at = cg.ni + k - 1 + nm;
        cg.et.insert(cg.et.begin() + at, 'D');
        cg.er.insert(cg.er.begin() + at, 0);
        cg.eg.insert(cg.eg.begin() + at, '*');
    }
    int64_t ki_ = st.ki - dt_ki;
    for (int64_t j = 0; j < dt_ki + (int64_t)score; ++j)
        cg.tr[ki_ + j] = in_tr(trK, to_ca(kmers[ki_ + j], k)) ? '=' : '.';
    for (auto& e : edits) {
        size_t at = cg.ni + k - 1;
        cg.et[at] = e.first;
        cg.eg[at] = e.second;
        ++cg.ni;
    }
    for (uint64_t j = 0; j < score; ++j) {
        cg.et[cg.ni + k - 1] = '=';
        ++cg.ni;
    }
    --cg.ni;
    st.ki += (int64_t)score - 1;
    st.ncorrection += edits.size();
}

void ThreadExt::edit_kmers_backward(ThreadState& st, Cigar& cg,
                                    const Graph& trK) {
    auto& kmers = *st.kmers;
    uint64_t k = st.ksize;
    uint64_t lbase = 1ULL << (2 * (k - 1));
    uint64_t lmask = 3ULL << (2 * (k - 1));
    int64_t ki = st.ki;
    vector<char> good(ki);
    vector<uint64_t> nts(ki);
    for (int64_t i = 0; i < ki; ++i) {
        good[i] = kmers[i] != NAN64;
        nts[i] = kmers[i] & lmask;
    }
    for (auto& e : edits) {
        if (e.first == 'X') ++nm;
        else if (e.first == 'D') ++nd;
        else ++ni;
    }
    dt_km = nd - ni;
    cg.ni += nd;
    if (dt_km > 0) {
        for (int64_t j = 0; j < dt_km; ++j) {
            kmers.insert(kmers.begin() + ki, 0);
            cg.tr.insert(cg.tr.begin() + ki, '*');
        }
    } else if (dt_km < 0) {
        kmers.erase(kmers.begin() + ki + dt_km, kmers.begin() + ki);
        cg.tr.erase(cg.tr.begin() + ki + dt_km, cg.tr.begin() + ki);
    }
    ki += dt_km;
    st.ki = ki;
    int64_t ki_ = ki;
    for (auto& e : edits) {
        if (e.first == 'X' || e.first == 'D') {
            kmers[ki_ - 1] = (kmers[ki_] >> 2)
                + (uint64_t)(3 - B2N[(uint8_t)e.second]) * lbase;
            --ki_;
        }
    }
    int64_t i = ki_;
    while (i > std::max<int64_t>(0, ki_ - (int64_t)k)) {
        if (!good[i - 1]) break;
        kmers[i - 1] = (kmers[i] >> 2) + nts[i - 1];
        --i;
    }
    int64_t lb = ki - nm - nd - (int64_t)score;
    for (int64_t j = ki - 1; j >= lb; --j) {
        if (cg.tr[j] == '*') ++nrk;
        cg.tr[j] = in_tr(trK, to_ca(kmers[j], k)) ? '=' : '.';
    }
    nrk -= nm + nd;
    st.nskip -= nrk;
    st.ncorrection += edits.size();

    // CIGAR patch
    int64_t cni = 0;
    int64_t nti_ = ki - dt_km;
    int64_t p = 0;
    while (p < nti_ + cni) {
        if (cg.et[p] == 'I') ++cni;
        ++p;
    }
    int64_t nti = nti_ + cni - 1;
    for (auto& e1 : edits) {
        if (e1.first == 'D') {
            ++nti;
            cg.et.insert(cg.et.begin() + nti, 'D');
            cg.er.insert(cg.er.begin() + nti, 0);
            cg.eg.insert(cg.eg.begin() + nti, '*');
        }
        if (cg.et[nti] == 'D') {
            if (e1.first == 'I') {
                cg.et.erase(cg.et.begin() + nti);
                cg.er.erase(cg.er.begin() + nti);
                cg.eg.erase(cg.eg.begin() + nti);
                --cg.ni;
            } else {
                cg.eg[nti] = comp_nt(e1.second);
            }
        } else {
            while (cg.et[nti] == 'I') --nti;
            cg.et[nti] = e1.first;
            cg.eg[nti] = e1.second ? comp_nt(e1.second) : 0;
        }
        --nti;
    }
    int64_t e0 = nti + 1;
    int64_t e1i = e0;
    for (uint64_t j = 0; j < score; ++j) {
        char t = cg.et[nti];
        if (t == '=') {
        } else if (t == '*') {
            cg.et[nti] = '=';
        } else {
            break;
        }
        --nti;
    }
    {
        char t = cg.et[e1i];
        while (t == 'X' || t == 'D' || t == 'I') {
            ++e1i;
            t = cg.et[e1i];
        }
        t = cg.et[e0 - 1];
        while (t == 'X' || t == 'D' || t == 'I') {
            --e0;
            t = cg.et[e0 - 1];
        }
    }
    vector<char> ets, rnts, gnts;
    for (int64_t j = e0; j < e1i; ++j) {
        ets.push_back(cg.et[j]);
        if (cg.er[j]) rnts.push_back(cg.er[j]);
        if (cg.eg[j]) gnts.push_back(cg.eg[j]);
    }
    if (rnts.size() == gnts.size()) {
        bool no_edit = true;
        for (size_t j = 0; j < rnts.size(); ++j)
            if (rnts[j] != gnts[j]) { no_edit = false; break; }
        if (no_edit) {
            int64_t dt_es = 0;
            for (int64_t j = e0; j < e1i; ++j) {
                char t = cg.et[j + dt_es];
                if (t == 'D') {
                    cg.et.erase(cg.et.begin() + j + dt_es);
                    cg.er.erase(cg.er.begin() + j + dt_es);
                    cg.eg.erase(cg.eg.begin() + j + dt_es);
                    --dt_es;
                } else {
                    cg.et[j + dt_es] = '=';
                    cg.eg[j + dt_es] = 0;
                }
            }
            cg.ni += dt_es;
            st.ncorrection -= e1i - e0;
            st.nskip -= e1i - e0;
        } else {
            if (ets.size() != rnts.size()) {
                int64_t dt_es = 0;
                int64_t dt_es_ = (int64_t)rnts.size() - (int64_t)ets.size();
                size_t jj = 0, kk = 0;
                for (int64_t j = e0; j < e1i; ++j) {
                    char t = cg.et[j + dt_es];
                    if (t == 'D' && dt_es != dt_es_) {
                        cg.et.erase(cg.et.begin() + j + dt_es);
                        cg.er.erase(cg.er.begin() + j + dt_es);
                        cg.eg.erase(cg.eg.begin() + j + dt_es);
                        --dt_es;
                    } else {
                        if (rnts[kk] == gnts[kk]) {
                            cg.et[j + dt_es] = '=';
                            cg.eg[j + dt_es] = 0;
                        } else {
                            cg.et[j + dt_es] = 'X';
                            cg.eg[j + dt_es] = gnts[jj];
                        }
                        ++jj;
                        ++kk;
                    }
                }
                cg.ni += dt_es;
                st.ncorrection += dt_es;
                st.nskip += dt_es;
            } else {
                for (size_t j = 0; j < rnts.size(); ++j) {
                    if (rnts[j] == gnts[j]) {
                        cg.et[e0 + j] = '=';
                        cg.eg[e0 + j] = 0;
                        --st.ncorrection;
                        --st.nskip;
                    }
                }
            }
        }
    } else {
        for (size_t j = 0; j < ets.size(); ++j) {
            if (cg.er[e0 + j] == cg.eg[e0 + j]) {
                cg.et[e0 + j] = '=';
                cg.eg[e0 + j] = 0;
                --st.ncorrection;
                --st.nskip;
            }
        }
    }
}

void get_out_nodes(const Graph& g, uint64_t node, uint64_t k,
                   vector<uint64_t>& nnds, bool (&nnts)[4]) {
    auto it = g.find(node);
    uint8_t bits = it == g.end() ? 0 : it->second;
    uint64_t base = (node & ((1ULL << 2 * (k - 1)) - 1)) << 2;
    nnds.clear();
    for (int i = 0; i < 4; ++i) {
        if ((bits >> i) & 1) {
            nnds.push_back(base + i);
            nnts[i] = true;
        }
    }
}

void get_next_nucs(const Graph& g, uint64_t node, bool (&nnts)[4]) {
    auto it = g.find(node);
    if (it != g.end()) {
        uint8_t bits = it->second;
        for (int i = 0; i < 4; ++i) nnts[i] = (bits >> i) & 1;
    }
}

struct Trip {
    bool mat[64] = {};
    void get1(int i, bool (&n)[4]) {
        for (int j = 0; j < 4; ++j)
            for (int kk = 0; kk < 4; ++kk) n[j] |= mat[i * 16 + j * 4 + kk];
    }
    void get2(int i, int j, bool (&n)[4]) {
        for (int kk = 0; kk < 4; ++kk) n[kk] |= mat[i * 16 + j * 4 + kk];
    }
};

bool error_correction_forward(const vector<uint64_t>& nnds, const Graph& g,
                              const vector<uint64_t>& kmers, int64_t ki,
                              const bool (&nts0)[4], ThreadExt& txt,
                              int mes, uint64_t k, uint64_t rmask) {
    bool nts1[4] = {}, nts2[4] = {};
    Trip gnt3;
    int64_t nkmers = kmers.size();
    uint64_t oldnt = kmers[ki] & 3;
    vector<uint64_t> n1, n2;
    for (uint64_t node_i : nnds) {
        int nt0 = node_i & 3;
        bool tmp1[4] = {};
        get_out_nodes(g, node_i, k, n1, tmp1);
        for (int i = 0; i < 4; ++i) nts1[i] |= tmp1[i];
        for (uint64_t node_ip1 : n1) {
            int nt1 = node_ip1 & 3;
            bool tmp2[4] = {};
            get_out_nodes(g, node_ip1, k, n2, tmp2);
            for (int i = 0; i < 4; ++i) nts2[i] |= tmp2[i];
            for (uint64_t node_ip2 : n2)
                gnt3.mat[nt0 * 16 + nt1 * 4 + (node_ip2 & 3)] = true;
        }
    }
    vector<char> good(k + 2, 0);
    for (uint64_t i = 0; i < std::min<uint64_t>(k + 2, nkmers - ki); ++i)
        good[i] = kmers[ki + i] != NAN64;

    if (ki + 1 < nkmers && nts1[kmers[ki + 1] & 3] && good[1]) {
        for (int nt0 = 0; nt0 < 4; ++nt0) {
            if (!nts0[nt0]) continue;
            uint64_t crk = kmers[ki] - oldnt + nt0;
            bool nn[4] = {};
            gnt3.get1(nt0, nn);
            for (uint64_t j = 1; j < std::min<uint64_t>(k + 1, nkmers - ki);
                 ++j) {
                if (!good[j]) break;
                crk = ((crk & rmask) << 2) + (kmers[ki + j] & 3);
                if (nn[crk & 3]) {
                    ++txt.nem1[nt0];
                    get_next_nucs(g, crk, nn);
                } else break;
            }
        }
    } else if (ki + 2 < nkmers && nts2[kmers[ki + 2] & 3] && mes >= 2
               && good[2]) {
        for (int nt0 = 0; nt0 < 4; ++nt0) {
            if (!nts0[nt0]) continue;
            uint64_t crk0 = kmers[ki] - oldnt + nt0;
            bool nn0[4] = {};
            gnt3.get1(nt0, nn0);
            for (int nt1 = 0; nt1 < 4; ++nt1) {
                if (!nn0[nt1]) continue;
                uint64_t crk1 = ((crk0 & rmask) << 2) + nt1;
                bool nn1[4] = {};
                gnt3.get2(nt0, nt1, nn1);
                for (uint64_t j = 2;
                     j < std::min<uint64_t>(k + 2, nkmers - ki); ++j) {
                    if (!good[j]) break;
                    crk1 = ((crk1 & rmask) << 2) + (kmers[ki + j] & 3);
                    if (nn1[crk1 & 3]) {
                        ++txt.nem2[nt0 * 4 + nt1];
                        get_next_nucs(g, crk1, nn1);
                    } else break;
                }
            }
        }
    }
    if (ki + 2 < nkmers && nts1[kmers[ki + 2] & 3] && mes >= 2 && good[2]) {
        for (int nt0 = 0; nt0 < 4; ++nt0) {
            if (!nts0[nt0]) continue;
            uint64_t crk = kmers[ki] - oldnt + nt0;
            bool nn[4] = {};
            gnt3.get1(nt0, nn);
            for (uint64_t j = 2; j < std::min<uint64_t>(k + 2, nkmers - ki);
                 ++j) {
                if (!good[j]) break;
                crk = ((crk & rmask) << 2) + (kmers[ki + j] & 3);
                if (nn[crk & 3]) {
                    ++txt.nemi[nt0];
                    get_next_nucs(g, crk, nn);
                } else break;
            }
        }
    }
    if (ki + 1 < nkmers && nts2[kmers[ki + 1] & 3] && mes >= 2 && good[1]) {
        for (int nt0 = 0; nt0 < 4; ++nt0) {
            if (!nts0[nt0]) continue;
            uint64_t crk0 = kmers[ki] - oldnt + nt0;
            bool nn0[4] = {};
            gnt3.get1(nt0, nn0);
            for (int nt1 = 0; nt1 < 4; ++nt1) {
                if (!nn0[nt1]) continue;
                uint64_t crk1 = ((crk0 & rmask) << 2) + nt1;
                bool nn1[4] = {};
                gnt3.get2(nt0, nt1, nn1);
                for (uint64_t j = 1;
                     j < std::min<uint64_t>(k + 1, nkmers - ki); ++j) {
                    if (!good[j]) break;
                    crk1 = ((crk1 & rmask) << 2) + (kmers[ki + j] & 3);
                    if (nn1[crk1 & 3]) {
                        ++txt.nemd[nt0 * 4 + nt1];
                        get_next_nucs(g, crk1, nn1);
                    } else break;
                }
            }
        }
    }
    if (ki + 1 < nkmers && nts0[kmers[ki + 1] & 3] && good[1]) {
        uint64_t crk = kmers[ki - 1];
        bool nn[4] = {nts0[0], nts0[1], nts0[2], nts0[3]};
        for (uint64_t j = 1; j < std::min<uint64_t>(k + 1, nkmers - ki);
             ++j) {
            if (!good[j]) break;
            crk = ((crk & rmask) << 2) + (kmers[ki + j] & 3);
            if (nn[crk & 3]) {
                ++txt.nei1;
                get_next_nucs(g, crk, nn);
            } else break;
        }
    }
    if (nts1[kmers[ki] & 3] && good[0]) {
        for (int nt0 = 0; nt0 < 4; ++nt0) {
            if (!nts0[nt0]) continue;
            uint64_t crk = kmers[ki] - oldnt + nt0;
            bool nn[4] = {};
            gnt3.get1(nt0, nn);
            for (uint64_t j = 0; j < std::min<uint64_t>(k, nkmers - ki);
                 ++j) {
                if (!good[j]) break;
                crk = ((crk & rmask) << 2) + (kmers[ki + j] & 3);
                if (nn[crk & 3]) {
                    ++txt.ned1[nt0];
                    get_next_nucs(g, crk, nn);
                } else break;
            }
        }
    }
    if (ki + 2 < nkmers && nts0[kmers[ki + 2] & 3] && mes >= 2 && good[2]) {
        uint64_t crk = kmers[ki - 1];
        bool nn[4] = {nts0[0], nts0[1], nts0[2], nts0[3]};
        for (uint64_t j = 2; j < std::min<uint64_t>(k + 2, nkmers - ki);
             ++j) {
            if (!good[j]) break;
            crk = ((crk & rmask) << 2) + (kmers[ki + j] & 3);
            if (nn[crk & 3]) {
                ++txt.nei2;
                get_next_nucs(g, crk, nn);
            } else break;
        }
    }
    if (nts2[kmers[ki] & 3] && mes >= 2 && good[0]) {
        for (int nt0 = 0; nt0 < 4; ++nt0) {
            if (!nts0[nt0]) continue;
            uint64_t crk0 = kmers[ki] - oldnt + nt0;
            bool nn0[4] = {};
            gnt3.get1(nt0, nn0);
            for (int nt1 = 0; nt1 < 4; ++nt1) {
                if (!nn0[nt1]) continue;
                uint64_t crk1 = ((crk0 & rmask) << 2) + nt1;
                bool nn1[4] = {};
                gnt3.get2(nt0, nt1, nn1);
                for (uint64_t j = 0; j < std::min<uint64_t>(k, nkmers - ki);
                     ++j) {
                    if (!good[j]) break;
                    crk1 = ((crk1 & rmask) << 2) + (kmers[ki + j] & 3);
                    if (nn1[crk1 & 3]) {
                        ++txt.ned2[nt0 * 4 + nt1];
                        get_next_nucs(g, crk1, nn1);
                    } else break;
                }
            }
        }
    }
    return !txt.get_edit();
}

bool error_correction_backward(uint64_t node, const Graph& g,
                               const vector<uint64_t>& kmers, int64_t ki,
                               ThreadExt& txt, int mes, uint64_t k,
                               uint64_t rmask) {
    uint64_t node_rc = nu_rc(node, k);
    vector<uint64_t> nnds_rc;
    bool nts0_rc[4] = {};
    get_out_nodes(g, node_rc, k, nnds_rc, nts0_rc);
    vector<uint64_t> kmers_rc(ki + 1);
    kmers_rc[0] = node_rc;
    int64_t kk = 1;
    for (int64_t j = ki - 1; j >= 0; --j, ++kk)
        kmers_rc[kk] = kmers[j] != NAN64 ? nu_rc(kmers[j], k) : NAN64;
    return error_correction_forward(nnds_rc, g, kmers_rc, 1, nts0_rc, txt,
                                    mes, k, rmask);
}

bool find_anchor_cg(const Graph& g, ThreadState& st, Cigar& cg,
                    const Graph& trK, uint64_t& node) {
    auto& kmers = *st.kmers;
    while (!g.count(kmers[st.ki])) {
        ++st.nskip;
        ++cg.ni;
        ++st.ki;
        if (st.ki >= (int64_t)kmers.size()) return false;
    }
    node = kmers[st.ki];
    cg.tr[st.ki] = in_tr(trK, to_ca(node, st.ksize)) ? '=' : '.';
    for (int64_t i = cg.ni; i < cg.ni + (int64_t)st.ksize; ++i)
        if (cg.et[i] == '*') cg.et[i] = '=';
    return true;
}

int is_thread_feasible(const Graph& g, const string& seq,
                       uint64_t thread_cth, bool correction, Cigar& cg,
                       const Graph& trK, uint64_t k, int maxncorrection,
                       vector<uint64_t>& kmers) {
    read2kmers_nc(seq, k, kmers);
    if (kmers.empty()) return 0;
    ThreadState st;
    st.kmers = &kmers;
    st.ksize = k;
    st.rmask = (1ULL << 2 * (k - 1)) - 1;
    int64_t maxnskip = kmers.size() >= thread_cth
        ? (int64_t)(kmers.size() - thread_cth) : 0;
    uint64_t node = kmers[0];

    if (!find_anchor_cg(g, st, cg, trK, node)) return 0;
    if (st.ki > 0 && correction && st.ncorrection < maxncorrection) {
        if (st.ki >= MSC + 1) {
            int mes = st.ki >= 2 * MSC + 2 ? 2 : 1;
            ThreadExt txtr(mes, true);
            bool skip = error_correction_backward(node, g, kmers, st.ki,
                                                  txtr, mes, k, st.rmask);
            if (!skip) txtr.edit_kmers_backward(st, cg, trK);
        }
    }
    ++st.ki;
    ++cg.ni;
    while (st.ki < (int64_t)kmers.size()) {
        int64_t ki = st.ki;
        if (kmers[ki] == NAN64 || kmers[ki] == kmers[ki - 1]) {
            cg.tr[ki] = '*';
            cg.et[cg.ni + k - 1] = '*';
            ++st.nskip;
            if (nskip_gt(st.nskip, maxnskip)) return 0;
            ++st.ki;
            ++cg.ni;
            continue;
        }
        if (kmers[ki - 1] == NAN64) {
            if (!find_anchor_cg(g, st, cg, trK, node)) break;
            if (nskip_gt(st.nskip, maxnskip)) return 0;
            ++st.ki;
            ++cg.ni;
            continue;
        }
        bool skip = true;
        bool nts0[4] = {};
        vector<uint64_t> nnds;
        get_out_nodes(g, node, k, nnds, nts0);
        for (uint64_t nnd : nnds) {
            if (kmers[ki] == nnd) {
                node = nnd;
                skip = false;
                cg.tr[ki] = in_tr(trK, to_ca(kmers[ki], k)) ? '=' : '.';
                cg.et[cg.ni + k - 1] = '=';
                break;
            }
        }
        if (!skip) {
            ++st.ki;
            ++cg.ni;
            continue;
        }
        if (ki + MSC >= (int64_t)kmers.size()) {
            // plain signed comparison here (mirrors the oracle exactly;
            // only the in-loop checks use the uint64-wrap semantics)
            st.nskip += (int64_t)kmers.size() - ki;
            if (st.nskip <= maxnskip)
                return st.ncorrection ? 2 : 1;
            return 0;
        }
        if (correction && st.ncorrection < maxncorrection) {
            int mes = (int64_t)kmers.size() - ki >= 2 * MSC + 2 ? 2 : 1;
            ThreadExt txtf(mes, false);
            skip = error_correction_forward(nnds, g, kmers, ki, nts0, txtf,
                                            mes, k, st.rmask);
            if (!skip) {
                st.nskip += txtf.edits.size();
                if (nskip_gt(st.nskip, maxnskip)) return 0;
                txtf.edit_kmers_forward(st, cg, trK);
                node = kmers[st.ki];
            } else {
                if (!find_anchor_cg(g, st, cg, trK, node)) break;
                int mes2 = 2;
                ThreadExt txtr(mes2, true);
                skip = error_correction_backward(node, g, kmers, st.ki,
                                                 txtr, mes2, k, st.rmask);
                if (!skip) {
                    txtr.edit_kmers_backward(st, cg, trK);
                    ++st.ncorrection;
                    int64_t gap = std::min<int64_t>(k, st.ki - txtr.nm
                                                    - txtr.nd)
                        - (int64_t)txtr.score;
                    int64_t ki0 = st.ki, ki1 = st.ki;
                    while (!skip && gap) {
                        ki0 = ki1;
                        ki1 = ki0 - txtr.nm - txtr.nd - (int64_t)txtr.score;
                        int mes3 = ki1 >= 2 * MSC + 2 ? 2 : 1;
                        if (ki1 < MSC + 1) break;
                        ThreadExt txtr2(mes3, true);
                        uint64_t node_ = kmers[ki1];
                        skip = error_correction_backward(
                            node_, g, kmers, ki1, txtr2, mes3, k, st.rmask);
                        if (!skip) {
                            int64_t ki_save = st.ki;
                            st.ki = ki1;
                            txtr2.edit_kmers_backward(st, cg, trK);
                            ki1 = st.ki;
                            st.ki = ki_save + txtr2.nd - txtr2.ni;
                            gap = std::min<int64_t>(k, ki1 - txtr2.nm
                                                    - txtr2.nd)
                                - (int64_t)txtr2.score;
                            txtr = txtr2;
                        }
                    }
                    if (gap) {
                        int64_t kk2 = ki1;
                        for (int64_t j = 0; j < gap; ++j) {
                            --kk2;
                            cg.tr[kk2] = '*';
                        }
                        st.nskip -= gap;
                    }
                    if (nskip_gt(st.nskip, maxnskip)) return 0;
                }
                if (skip) {
                    if (!find_anchor_cg(g, st, cg, trK, node)) break;
                    if (nskip_gt(st.nskip, maxnskip)) return 0;
                    ++st.ki;
                    ++cg.ni;
                    continue;
                }
            }
        } else {
            if (!find_anchor_cg(g, st, cg, trK, node)) break;
            if (nskip_gt(st.nskip, maxnskip)) return 0;
            ++st.ki;
            ++cg.ni;
            continue;
        }
        ++st.ki;
        ++cg.ni;
    }
    if (st.nskip <= maxnskip && st.ncorrection <= maxncorrection)
        return st.ncorrection ? 2 : 1;
    return 0;
}

// ---- RLE writers: exact mirrors of engine/threading.write_cigar /
// write_annot (themselves transliterations of the reference's
// writeCigar/writeAnnot, aQueryFasta_thread.cpp:1701-1740, including
// the trailing-element quirks). es entries here are (et, eg) pairs as
// the Cigar struct holds them; eg==0 renders '*' like the packed
// serialization in dtk_thread_read.
void rle_cigar(const vector<char>& et, const vector<char>& eg,
               string& out) {
    size_t n = et.size();
    out.clear();
    if (!n) { out = "*"; return; }
    auto gch = [&](size_t i) { return eg[i] ? eg[i] : '*'; };
    size_t i0 = 0, i = 1;
    uint64_t ct = 1;
    while (i < n) {
        char t0 = et[i0];
        if (t0 == '=' || t0 == '.' || t0 == '*') {
            while (et[i] == t0) {
                ++ct; ++i;
                if (i == n) break;
            }
            out += std::to_string(ct); out += t0;
        } else if (t0 == 'X') {
            out += 'X'; out += gch(i0);
        } else if (t0 == 'D') {
            if (et[i] == 'I') { out += 'X'; out += gch(i0); ++i; }
            else              { out += 'D'; out += gch(i0); }
        } else if (t0 == 'I') {
            if (et[i] == 'D') { out += 'X'; out += gch(i); ++i; }
            else              { out += 'I'; }
        } else {
            out += t0;
        }
        if (i == n) return;
        ct = 1; i0 = i; ++i;
    }
    out += std::to_string(ct); out += et[i0];
}

void rle_annot(const vector<char>& tr, string& out) {
    out.clear();
    if (tr.empty()) { out = "*"; return; }
    size_t n = tr.size(), i = 1;
    uint64_t ct = 1;
    char c0 = tr[0];
    while (i < n) {
        if (c0 == '=' || c0 == '.' || c0 == '*') {
            while (i < n && tr[i] == c0) { ++ct; ++i; }
            out += std::to_string(ct); out += c0;
            if (i == n) return;
        } else {
            out += c0;
        }
        ct = 1; c0 = tr[i]; ++i;
    }
    out += std::to_string(ct); out += c0;
}

typedef std::unordered_map<uint64_t, uint64_t> CountMap;

}  // namespace

extern "C" {

// ---- deferred count maps (per locus) ----
void* dtk_counts_new() { return new CountMap(); }
void dtk_counts_free(void* p) { delete (CountMap*)p; }
int64_t dtk_counts_size(void* p) {
    return (int64_t)((CountMap*)p)->size();
}
// Dump (key, count) pairs and clear the map; caller sizes the buffers
// from dtk_counts_size.
void dtk_counts_drain(void* p, uint64_t* keys, uint64_t* vals) {
    CountMap* m = (CountMap*)p;
    int64_t i = 0;
    for (auto& kv : *m) { keys[i] = kv.first; vals[i] = kv.second; ++i; }
    m->clear();
}

// Batched threading fallback: npairs pairs, codes as (2*npairs, stride)
// u8 rows of 2-bit base codes (255 = non-ACGT), per-pair graph/trK/count
// handles.  Walks fan over `nworkers` internal threads (the graph maps
// are read-only during the walk).  Corrected-k-mer counts of aligned
// mates accumulate into cnts[i] (only keys present in trks[i], matching
// host_align._thread_pair's `if km in trc`).  With want_aln, cg_out row
// 2*i+m receives "<cigar>\t<annot>" (RLE strings, length in cg_lens).
// Returns the number of aligned mates.
int64_t dtk_thread_pairs(void** graphs, void** trks, void** cnts,
                         const uint8_t* codes, const int32_t* rlens,
                         int64_t npairs, int64_t stride,
                         uint64_t thread_cth, int correction,
                         uint64_t ksize, int maxncorrection,
                         int nworkers, int want_aln,
                         uint8_t* status_out,
                         char* cg_out, int64_t cg_stride,
                         int64_t* cg_lens) {
    if (npairs <= 0) return 0;
    int nw = nworkers < 1 ? 1 : nworkers;
    if (nw > npairs) nw = (int)npairs;
    struct Ev { int64_t pi; uint64_t ca; };
    vector<vector<Ev>> evs(nw);
    std::atomic<int64_t> next{0};
    std::atomic<int64_t> naln{0};

    auto work = [&](int w) {
        string s;
        vector<uint64_t> kmers;
        string cig, ann;
        int64_t local_aln = 0;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= npairs) break;
            Graph* g = (Graph*)graphs[i];
            Graph* trK = (Graph*)trks[i];
            for (int m = 0; m < 2; ++m) {
                int64_t r = 2 * i + m;
                const uint8_t* row = codes + r * stride;
                int32_t L = rlens[r];
                s.assign(L, 'N');
                for (int32_t j = 0; j < L; ++j) {
                    uint8_t c = row[j];
                    if (c < 4) s[j] = ALPHA[c];
                }
                Cigar cg;
                cg.init(s, ksize);
                int st = is_thread_feasible(*g, s, thread_cth,
                                            correction != 0, cg, *trK,
                                            ksize, maxncorrection, kmers);
                status_out[r] = (uint8_t)st;
                if (st) {
                    ++local_aln;
                    for (uint64_t km : kmers)
                        if (km != NAN64)
                            evs[w].push_back({i, to_ca(km, ksize)});
                }
                if (want_aln) {
                    rle_cigar(cg.et, cg.eg, cig);
                    rle_annot(cg.tr, ann);
                    int64_t need = (int64_t)(cig.size() + 1 + ann.size());
                    char* dst = cg_out + r * cg_stride;
                    if (need > cg_stride) need = cg_stride;  // never overrun
                    int64_t nc = std::min<int64_t>(cig.size(), need);
                    memcpy(dst, cig.data(), nc);
                    if (nc < need) dst[nc] = '\t';
                    int64_t na = need - nc - 1;
                    if (na > 0) memcpy(dst + nc + 1, ann.data(), na);
                    cg_lens[r] = need;
                }
            }
        }
        naln.fetch_add(local_aln);
    };

    if (nw == 1) {
        work(0);
    } else {
        vector<std::thread> ths;
        ths.reserve(nw);
        for (int w = 0; w < nw; ++w) ths.emplace_back(work, w);
        for (auto& t : ths) t.join();
    }

    // single-threaded merge: counts are commutative adds; membership in
    // trK gates the increment exactly like the per-pair path
    for (auto& ve : evs) {
        for (auto& e : ve) {
            Graph* trK = (Graph*)trks[e.pi];
            if (trK->count(e.ca)) ++(*(CountMap*)cnts[e.pi])[e.ca];
        }
    }
    return naln.load();
}

void* dtk_graph_new() { return new Graph(); }

void dtk_graph_add(void* gp, const uint64_t* keys, const uint8_t* masks,
                   int64_t n) {
    Graph* g = (Graph*)gp;
    g->reserve(n);
    for (int64_t i = 0; i < n; ++i) (*g)[keys[i]] = masks[i];
}

void dtk_graph_free(void* gp) { delete (Graph*)gp; }

// Returns status (0/1/2); fills es_out (cigar op chars, len in *es_len),
// tr_out (annot chars, len in *tr_len), kmers_out (corrected stream, count
// in *nk_out; caps are the respective *_len inputs).
int dtk_thread_read(void* gp, void* trkp, const char* seq, int64_t seqlen,
                    uint64_t thread_cth, int correction, uint64_t ksize,
                    int maxncorrection, char* es_out, int64_t* es_len,
                    char* tr_out, int64_t* tr_len, uint64_t* kmers_out,
                    int64_t* nk_out) {
    Graph* g = (Graph*)gp;
    Graph* trK = (Graph*)trkp;
    string s(seq, seqlen);
    Cigar cg;
    cg.init(s, ksize);
    vector<uint64_t> kmers;
    int st = is_thread_feasible(*g, s, thread_cth, correction, cg, *trK,
                                ksize, maxncorrection, kmers);
    // serialize es ops: '=','*','I' as-is; 'X' -> 'X'+graphchar;
    // 'D' -> 'D'+graphchar  (caller rebuilds the reference RLE strings)
    int64_t cap_es = *es_len, cap_tr = *tr_len, cap_k = *nk_out;
    int64_t ne = 0;
    for (size_t i = 0; i < cg.et.size() && ne + 2 < cap_es; ++i) {
        es_out[ne++] = cg.et[i];
        if (cg.et[i] == 'X' || cg.et[i] == 'D')
            es_out[ne++] = cg.eg[i] ? cg.eg[i] : '*';
    }
    *es_len = ne;
    int64_t nt = std::min<int64_t>(cg.tr.size(), cap_tr);
    memcpy(tr_out, cg.tr.data(), nt);
    *tr_len = nt;
    int64_t nk2 = std::min<int64_t>(kmers.size(), cap_k);
    memcpy(kmers_out, kmers.data(), nk2 * sizeof(uint64_t));
    *nk_out = nk2;
    return st;
}

}  // extern "C"
