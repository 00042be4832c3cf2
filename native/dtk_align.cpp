// Native host-referee engine: C++ twin of engine/host_align.process_pair
// (asgn counting mode).  The device engine resolves ~99% of pairs;
// pairs whose outcome depends on the reference's early-stop scan order
// (vote ties / test2 boundary / expansion overflow) are recomputed
// exactly on the host — this engine runs that path at C++ speed instead
// of Python speed (the semantics mirror the golden-verified Python
// implementation statement for statement).
//
// ctypes API:
//   dtk_eng_new / dtk_eng_free
//   dtk_eng_set_locus(li, tr_kmers, fl_kmers)   TR/flank membership sets
//   dtk_eng_set_bait(li, keys, vals)            FP [mi,ma] windows
//   dtk_eng_pair(...)                           one read pair -> verdict
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::vector;

const uint64_t NAN64 = 0xFFFFFFFFFFFFFFFFULL;
const uint32_t NAN32 = 0xFFFFFFFFu;

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

struct Eng {
    std::unordered_map<uint64_t, uint32_t> dbi;
    vector<uint32_t> vv_own;
    const uint32_t* vv = nullptr;   // hash mode: vv_own.data()
    int64_t nloci;
    vector<std::unordered_set<uint64_t>> tr, fl;
    vector<std::unordered_map<uint64_t, uint16_t>> bait;
    vector<uint8_t> qc;
    bool has_qc = false;
    // flat mode (production scale): zero-copy views over the caller's
    // sorted arrays — no 1e8-entry hash build, binary-search probes.
    // The caller owns the memory for the engine's lifetime.
    bool flat = false;
    const uint64_t* fkeys = nullptr;    // sorted dbi keys
    const uint32_t* fvals = nullptr;
    int64_t fn = 0;
    const uint64_t* ftrk = nullptr;     // per-locus sorted TR kmers (CSR)
    const int64_t* ftro = nullptr;      // offsets, nloci+1
    const uint64_t* fflk = nullptr;     // per-locus sorted flank kmers
    const int64_t* fflo = nullptr;
};

inline bool sorted_has(const uint64_t* a, int64_t lo, int64_t hi,
                       uint64_t km) {
    const uint64_t* p = std::lower_bound(a + lo, a + hi, km);
    return p != a + hi && *p == km;
}

inline bool dbi_has(const Eng& e, uint64_t km) {
    if (e.flat) return sorted_has(e.fkeys, 0, e.fn, km);
    return e.dbi.count(km) != 0;
}

inline bool dbi_get(const Eng& e, uint64_t km, uint32_t* val) {
    if (e.flat) {
        const uint64_t* p = std::lower_bound(e.fkeys, e.fkeys + e.fn, km);
        if (p == e.fkeys + e.fn || *p != km) return false;
        *val = e.fvals[p - e.fkeys];
        return true;
    }
    auto it = e.dbi.find(km);
    if (it == e.dbi.end()) return false;
    *val = it->second;
    return true;
}

inline bool in_tr(const Eng& e, int64_t locus, uint64_t km) {
    if (e.flat)
        return sorted_has(e.ftrk, e.ftro[locus], e.ftro[locus + 1], km);
    return e.tr[locus].count(km) != 0;
}

inline bool in_fl(const Eng& e, int64_t locus, uint64_t km) {
    if (e.flat)
        return sorted_has(e.fflk, e.fflo[locus], e.fflo[locus + 1], km);
    return e.fl[locus].count(km) != 0;
}

// canonical k-mers with NAN64 at invalid windows (ops/kmers_np semantics)
void seq2cakmers(const char* seq, int64_t n, int k, vector<uint64_t>& out) {
    int64_t nk = n - k + 1;
    out.clear();
    if (nk <= 0) return;
    out.assign(nk, NAN64);
    uint64_t mask = (1ULL << 2 * k) - 1;
    uint64_t km = 0, rc = 0;
    int run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t b = B2N[(uint8_t)seq[i]];
        if (b == 255) {
            run = 0;
            km = rc = 0;
            continue;
        }
        km = ((km << 2) | b) & mask;
        rc = (rc >> 2) | ((uint64_t)(3 - b) << (2 * (k - 1)));
        if (++run >= k)
            out[i - k + 1] = km < rc ? km : rc;
    }
}

bool any_valid(const vector<uint64_t>& v) {
    for (uint64_t x : v)
        if (x != NAN64) return true;
    return false;
}

bool subfilter_one(const Eng& e, const vector<uint64_t>& kms, int nf,
                   int nmf) {
    int64_t L = kms.size();
    int64_t S = L / (nf - 1);
    int h = 0;
    for (int i = 0; i < nf; ++i) {
        int64_t i1 = (i != nf - 1) ? i * S : L - 1;
        if (dbi_has(e, kms[i1])) {
            if (++h >= nmf) break;
        }
    }
    return h < nmf;
}

// (kmer, val) hits in read order; kf flag
int kfilter(const Eng& e, const vector<uint64_t>& kms, int cth,
            vector<std::pair<uint64_t, uint32_t>>& its) {
    its.clear();
    int64_t nk = kms.size();
    if (nk < cth) return 1;
    int64_t max_ns = nk - cth, ns = 0;
    for (uint64_t km : kms) {
        uint32_t v;
        if (!dbi_get(e, km, &v)) {
            if (++ns > max_ns) {
                its.clear();
                return 1;
            }
        } else {
            its.emplace_back(km, v);
        }
    }
    return 0;
}

struct Entry {
    uint64_t km;
    uint32_t val;
    int f, r;
};

// countDupRemove + nmappedloci std::sort + remain suffix sums
void fillstats(const Eng& e,
               const vector<std::pair<uint64_t, uint32_t>>& its1,
               const vector<std::pair<uint64_t, uint32_t>>& its2,
               vector<Entry>& entries, vector<int64_t>& remain) {
    std::unordered_map<uint64_t, Entry> agg;
    for (auto& p : its1) {
        auto it = agg.find(p.first);
        if (it == agg.end()) agg[p.first] = {p.first, p.second, 1, 0};
        else ++it->second.f;
    }
    for (auto& p : its2) {
        auto it = agg.find(p.first);
        if (it == agg.end()) agg[p.first] = {p.first, p.second, 0, 1};
        else ++it->second.r;
    }
    vector<uint64_t> kms;
    kms.reserve(agg.size());
    for (auto& p : agg) kms.push_back(p.first);
    std::sort(kms.begin(), kms.end());
    int64_t n = kms.size();
    vector<Entry> byk(n);
    vector<uint64_t> nmapped(n);
    for (int64_t i = 0; i < n; ++i) {
        byk[i] = agg[kms[i]];
        uint32_t v = byk[i].val;
        nmapped[i] = (v & 1) ? e.vv[v >> 1] : 1;
    }
    // index sort by nmapped — the libstdc++ introsort tie order the
    // Python engine replays through its native helper
    vector<uint64_t> idx(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    std::sort(idx.begin(), idx.end(), [&](uint64_t a, uint64_t b) {
        return nmapped[a] < nmapped[b];
    });
    entries.resize(n);
    for (int64_t i = 0; i < n; ++i) entries[i] = byk[idx[i]];
    int64_t dupsum = 0;
    for (auto& en : entries) dupsum += en.f + en.r;
    remain.assign(n, 0);
    if (n) {
        remain[0] = dupsum - entries[0].f - entries[0].r;
        for (int64_t i = 1; i < n - 1; ++i)
            remain[i] = remain[i - 1] - entries[i].f - entries[i].r;
    }
}

void expand_loci(const Eng& e, uint32_t v, vector<uint32_t>& out) {
    out.clear();
    if (v & 1) {
        uint32_t off = v >> 1;
        uint32_t n = e.vv[off];
        for (uint32_t i = 0; i < n; ++i) out.push_back(e.vv[off + 1 + i]);
    } else {
        out.push_back(v >> 1);
    }
}

void find_matching_locus(const Eng& e, const vector<Entry>& entries,
                         const vector<int64_t>& remain, int cth,
                         uint32_t& tri0, int64_t& fc, int64_t& rc) {
    std::unordered_map<uint32_t, int64_t> hits1, hits2;
    uint32_t top_i = NAN32, sec_i = NAN32;
    int64_t top_f = 0, top_r = 0, sec_f = 0, sec_r = 0;
    vector<uint32_t> loci;
    int64_t n = entries.size();
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = entries[i].val;
        int f = entries[i].f, r = entries[i].r;
        expand_loci(e, v, loci);
        for (uint32_t locus : loci) {
            int64_t h1 = hits1[locus] + f;
            int64_t h2 = hits2[locus] + r;
            hits1[locus] = h1;
            hits2[locus] = h2;
            if (h1 + h2 > top_f + top_r) {
                if (top_i != locus) {
                    sec_i = top_i;
                    sec_f = top_f;
                    sec_r = top_r;
                    top_i = locus;
                }
                top_f = h1;
                top_r = h2;
            } else if (h1 + h2 > sec_f + sec_r) {
                sec_i = locus;
                sec_f = h1;
                sec_r = h2;
            }
        }
        if (!((top_f + top_r - sec_f - sec_r) < remain[i])) {
            int64_t j = i;
            while ((top_f < cth && cth - top_f <= remain[j])
                   || (top_r < cth && cth - top_r <= remain[j])) {
                ++j;
                if (j >= n) break;
                uint32_t vj = entries[j].val;
                int fj = entries[j].f, rj = entries[j].r;
                if (vj & 1) {
                    expand_loci(e, vj, loci);
                    for (uint32_t locus : loci) {
                        if (locus == top_i) {
                            top_f += fj;
                            top_r += rj;
                            break;
                        }
                    }
                } else {
                    if ((vj >> 1) == top_i) {
                        top_f += fj;
                        top_r += rj;
                    }
                }
            }
            break;
        }
    }
    tri0 = top_i;
    fc = top_f;
    rc = top_r;
}

// qString2qMask exact port (aQueryFasta_thread.h:1043-1078)
void qmask(const char* qual, int64_t nq, int qth, int k,
           vector<uint8_t>& qkm) {
    int64_t nk = nq - k + 1;
    qkm.assign(nk > 0 ? nk : 0, 0);
    if (nk <= 0) return;
    vector<int> qs(nq);
    for (int64_t i = 0; i < nq; ++i) qs[i] = qual[i] - 33;
    int64_t qi = 0, ki = 0;
    while (qs[qi] < qth) {
        ++qi;
        ++ki;
        if (qi >= nk) return;
    }
    while (qi < nk) {
        bool passed = true;
        int64_t qj = qi;
        while (qi < qj + k) {
            if (qs[qi] < qth) {
                passed = false;
                ki = qi;
                while (qs[qi] < qth) {
                    ++qi;
                    ++ki;
                    if (qi >= nk) return;
                }
                break;
            }
            ++qi;
        }
        if (passed) {
            qkm[ki] = 1;
            ++ki;
            if (qi >= nk) return;
            while (qs[qi] >= qth) {
                qkm[ki] = 1;
                ++qi;
                ++ki;
                if (qi >= nk) return;
            }
            ki = qi;
            while (qs[qi] < qth) {
                ++qi;
                ++ki;
                if (qi >= nk) return;
            }
        }
    }
}

bool bfilter(const std::unordered_map<uint64_t, uint16_t>& bdb,
             const vector<uint64_t>& kms, const vector<uint8_t>* qkm) {
    if (kms.empty()) return false;
    std::unordered_map<uint64_t, uint8_t> kc;
    for (size_t i = 0; i < kms.size(); ++i) {
        if (qkm && !(*qkm)[i]) continue;
        ++kc[kms[i]];
    }
    for (auto& p : kc) {
        auto it = bdb.find(p.first);
        if (it != bdb.end()) {
            uint8_t mi = it->second >> 8, ma = it->second & 0xFF;
            if (p.second < mi || p.second > ma) return true;
        }
    }
    return false;
}

struct Asgn {
    int kf = 0, hf = 0, bf = 0, qf = 0, af = 0, rm = 0, qn = 0, qm = 0;
    int64_t si = -1, ei = -1, si_ = -1, ei_ = -1;
    int64_t nt = 0, bs = 0, ti = -1;
};

// assignTRkmc exact (mirrors engine/host_align.assign_trkmc)
void assign_trkmc(const Eng& e, int64_t locus, const vector<uint64_t>& kms,
                  Asgn& r, bool okam, int nm_tr, int max_nt,
                  vector<uint8_t>& as_) {
    as_.assign(kms.size(), 0);
    if (!okam && r.rm) return;
    int64_t nk = kms.size();
    int64_t ntr = 0;
    for (int64_t i = 0; i < nk; ++i) {
        if (in_fl(e, locus, kms[i])) as_[i] = 1;
        else if (in_tr(e, locus, kms[i])) {
            as_[i] = 2;
            ++ntr;
        }
    }
    if (r.rm) {
        r.nt = -1;
        r.bs = -1;
        r.ti = -1;
        return;
    }
    int s_ = 0, s__ = 0;
    int64_t ti1 = -1, ti2 = -1, si1 = -1, ei1 = -1, si2 = -1, ei2 = -1;
    int64_t nt = 0, bs = 0;
    for (int64_t i = 0; i < nk; ++i) {
        int s = as_[i];
        if (s && s__) {
            if (s != s__) {
                ++nt;
                if (nt > max_nt) {
                    r.nt = nt;
                    r.bs = bs;
                    r.ti = ti1;
                    r.af = 1;
                    r.rm = 1;
                    return;
                }
                if (nt == 1) {
                    ti1 = i;
                    if (s_) { si1 = -1; ei1 = -1; }
                } else if (nt == 2) {
                    if (bs == 2) {
                        r.nt = nt;
                        r.bs = bs;
                        r.ti = ti1;
                        r.af = 1;
                        r.rm = 1;
                        return;
                    }
                    ti2 = i;
                    if (s_) { si2 = -1; ei2 = -1; }
                }
            }
        }
        if (!bs && s) bs = s;
        if (!s) {
            if (nt == 0) {
                if (!s_) ++ei1;
                else { si1 = i; ei1 = i + 1; }
            }
            if (nt == 1) {
                if (!s_) ++ei2;
                else { si2 = i; ei2 = i + 1; }
            }
        }
        s_ = s;
        if (s) s__ = s;
    }
    r.nt = nt;
    r.bs = bs;
    r.ti = ti1;
    if (nt == 0) {
        if (bs != 2) {
            r.af = 1;
            r.rm = 1;
            return;
        }
        r.si = 0; r.ei = nk; r.si_ = 0; r.ei_ = nk;
    } else if (nt == 1) {
        if (bs == 1) {
            r.si = si1 >= 0 ? (si1 + ei1) / 2 : ti1;
            r.ei = nk;
            r.si_ = si1 >= 0 ? ei1 : ti1;
            r.ei_ = nk;
        } else {
            r.si = 0;
            r.ei = si1 >= 0 ? (si1 + ei1) / 2 : ti1;
            r.si_ = 0;
            r.ei_ = si1 >= 0 ? si1 : ti1;
        }
    } else {
        if (ntr < nm_tr) {
            r.af = 1;
            r.rm = 1;
            return;
        }
        r.si = si1 >= 0 ? (si1 + ei1) / 2 : ti1;
        r.ei = si2 >= 0 ? (si2 + ei2) / 2 : ti2;
        r.si_ = ei1 >= 0 ? ei1 : ti1;
        r.ei_ = si2 >= 0 ? si2 : ti2;
    }
}

}  // namespace

extern "C" {

void* dtk_eng_new(const uint64_t* dbi_keys, const uint32_t* dbi_vals,
                  int64_t n, const uint32_t* vv, int64_t nvv,
                  int64_t nloci, const uint8_t* qc) {
    Eng* e = new Eng();
    e->dbi.reserve(n);
    for (int64_t i = 0; i < n; ++i) e->dbi[dbi_keys[i]] = dbi_vals[i];
    e->vv_own.assign(vv, vv + nvv);
    e->vv = e->vv_own.data();
    e->nloci = nloci;
    e->tr.resize(nloci);
    e->fl.resize(nloci);
    e->bait.resize(nloci);
    if (qc) {
        e->qc.assign(qc, qc + nloci);
        e->has_qc = true;
    }
    return e;
}

// Production-scale constructor: sorted-array views, ZERO copies.  The
// caller (engine/native_referee.py) keeps every array alive for the
// engine's lifetime; dbi keys and per-locus CSR slices must be sorted.
void* dtk_eng_new_flat(const uint64_t* dbi_keys, const uint32_t* dbi_vals,
                       int64_t n, const uint32_t* vv, int64_t nvv,
                       int64_t nloci, const uint8_t* qc,
                       const uint64_t* trk, const int64_t* tro,
                       const uint64_t* flk, const int64_t* flo) {
    Eng* e = new Eng();
    e->flat = true;
    e->fkeys = dbi_keys;
    e->fvals = dbi_vals;
    e->fn = n;
    e->vv = vv;
    (void)nvv;
    e->nloci = nloci;
    e->ftrk = trk;
    e->ftro = tro;
    e->fflk = flk;
    e->fflo = flo;
    e->bait.resize(nloci);
    if (qc) {
        e->qc.assign(qc, qc + nloci);
        e->has_qc = true;
    }
    return e;
}

void dtk_eng_set_locus(void* ep, int64_t li, const uint64_t* trk,
                       int64_t ntr, const uint64_t* flk, int64_t nfl) {
    Eng* e = (Eng*)ep;
    e->tr[li].reserve(ntr);
    for (int64_t i = 0; i < ntr; ++i) e->tr[li].insert(trk[i]);
    e->fl[li].reserve(nfl);
    for (int64_t i = 0; i < nfl; ++i) e->fl[li].insert(flk[i]);
}

void dtk_eng_set_bait(void* ep, int64_t li, const uint64_t* keys,
                      const uint16_t* vals, int64_t n) {
    Eng* e = (Eng*)ep;
    for (int64_t i = 0; i < n; ++i) e->bait[li][keys[i]] = vals[i];
}

void dtk_eng_free(void* ep) { delete (Eng*)ep; }

// Verdict layout (int64): [stage, dest, dst0, nk1, nk2,
//   then per mate 15 ints: kf,hf,bf,qf,af,rm,qn,qm,si,ei,si_,ei_,nt,bs,ti]
// stages: 0 short, 1 subfiltered, 2 kfiltered-both, 3 vote-fail,
//         4 qc-drop, 5 processed
int dtk_eng_pair(void* ep, const char* seq1, int64_t n1, const char* seq2,
                 int64_t n2, const char* qual1, const char* qual2,
                 int k, int cth, int nf, int nmf, int nm_tr, int max_nt,
                 int okam, int use_bait, int use_qc, int qth,
                 int64_t* verdict, uint8_t* as1, uint8_t* as2,
                 uint64_t* kms1_out, uint64_t* kms2_out) {
    Eng& e = *(Eng*)ep;
    vector<uint64_t> kms1, kms2;
    seq2cakmers(seq1, n1, k, kms1);
    seq2cakmers(seq2, n2, k, kms2);
    int64_t* vd = verdict;
    Asgn r1, r2;
    auto emit = [&](int stage, int64_t dest, int64_t dst0) {
        vd[0] = stage;
        vd[1] = dest;
        vd[2] = dst0;
        vd[3] = kms1.size();
        vd[4] = kms2.size();
        const Asgn* rs[2] = {&r1, &r2};
        for (int m = 0; m < 2; ++m) {
            int64_t* o = vd + 5 + 15 * m;
            const Asgn& r = *rs[m];
            o[0] = r.kf; o[1] = r.hf; o[2] = r.bf; o[3] = r.qf;
            o[4] = r.af; o[5] = r.rm; o[6] = r.qn; o[7] = r.qm;
            o[8] = r.si; o[9] = r.ei; o[10] = r.si_; o[11] = r.ei_;
            o[12] = r.nt; o[13] = r.bs; o[14] = r.ti;
        }
        memcpy(kms1_out, kms1.data(), kms1.size() * 8);
        memcpy(kms2_out, kms2.data(), kms2.size() * 8);
        return stage;
    };

    if (!any_valid(kms1) || !any_valid(kms2)) return emit(0, e.nloci, -1);
    if (nf && nmf) {
        if (subfilter_one(e, kms1, nf, nmf) ||
            subfilter_one(e, kms2, nf, nmf))
            return emit(1, e.nloci, -1);
    }
    vector<std::pair<uint64_t, uint32_t>> its1, its2;
    r1.kf = kfilter(e, kms1, cth, its1);
    r2.kf = kfilter(e, kms2, cth, its2);
    r1.rm |= r1.kf;
    r2.rm |= r2.kf;
    if (r1.rm && r2.rm) return emit(2, e.nloci, -1);

    vector<Entry> entries;
    vector<int64_t> remain;
    fillstats(e, its1, its2, entries, remain);
    uint32_t tri0;
    int64_t fc, rc;
    find_matching_locus(e, entries, remain, cth, tri0, fc, rc);
    bool test1 = fc >= cth && rc >= cth;
    bool test2 = fc + rc >= 2 * cth;
    int64_t dest, dst0;
    if ((test1 || test2) && tri0 != NAN32) {
        dest = dst0 = tri0;
    } else {
        if (!r1.rm) r1.hf = 1;
        if (!r2.rm) r2.hf = 1;
        r1.rm = 1;
        r2.rm = 1;
        return emit(3, e.nloci, tri0 == NAN32 ? -2 : (int64_t)tri0);
    }
    if (use_qc && e.has_qc && !e.qc[dest]) return emit(4, e.nloci, dst0);

    // pre-bait rm flags (the nBaitFiltered stat counts bf & ~rm_pre)
    verdict[35] = r1.rm;
    verdict[36] = r2.rm;
    if (use_bait) {
        const auto& bdb = e.bait[dest];
        bool bf1, bf2;
        if (qual1) {
            vector<uint8_t> q1, q2;
            qmask(qual1, n1, qth, k, q1);
            qmask(qual2, n2, qth, k, q2);
            bf1 = bfilter(bdb, kms1, &q1);
            bf2 = bfilter(bdb, kms2, &q2);
        } else {
            bf1 = bfilter(bdb, kms1, nullptr);
            bf2 = bfilter(bdb, kms2, nullptr);
        }
        r1.bf = bf1;
        r2.bf = bf2;
        if (bf1 || bf2) {
            r1.rm = 1;
            r2.rm = 1;
            dest = e.nloci;
        }
    }

    vector<uint8_t> a1, a2;
    if (okam || !r1.rm || !r2.rm) {
        assign_trkmc(e, dst0, kms1, r1, okam, nm_tr, max_nt, a1);
        assign_trkmc(e, dst0, kms2, r2, okam, nm_tr, max_nt, a2);
    } else {
        a1.assign(kms1.size(), 0);
        a2.assign(kms2.size(), 0);
    }
    memcpy(as1, a1.data(), a1.size());
    memcpy(as2, a2.data(), a2.size());
    if (r1.rm && r2.rm) dest = e.nloci;
    return emit(5, dest, dst0);
}

}  // extern "C"
