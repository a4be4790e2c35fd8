// Native host runtime for compseed: the post-SAL alignment tail.
//
// The device owns the FM-index queries and the banded-SW extension DP; this
// library owns the irregular host-side logic around them (the role
// mapping/comp_seed.cpp's tail plays in the reference):
//
//   * seed chaining + chain filtering       (contract: comp_seed.cpp:176-409)
//   * SeqPair emission + acceptance/requeue (contract: comp_seed.cpp:1319-2126)
//   * ordered purge of contained seeds      (contract: comp_seed.cpp:2141-2235)
//   * dedup/patch, mapq, primary marking    (contract: comp_seed.cpp:584-797)
//   * CIGAR/NM/MD + SAM emission            (contract: comp_seed.cpp:803-1123,
//                                            bwalib/bwa.c:147-233)
//
// This is a fresh implementation of those semantics (not a copy); the
// byte-level contract is enforced by the differential test-suite against
// the reference binaries and the Python oracle.
//
// Exposed as a C ABI consumed via ctypes (compseed/native).
//
// Build: g++ -O2 -fPIC -shared -o libcompseed_host.so compseed_host.cpp

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

using std::string;
using std::vector;

using i64 = int64_t;
using u64 = uint64_t;
using i32 = int32_t;
using u32 = uint32_t;
using u8 = uint8_t;

// ---------------------------------------------------------------------
// kt_for equivalent (cstl/kthread.c:51-63): dynamic work distribution
// over an atomic counter.  Every parallelized loop body is per-read (or
// per-pair) independent, so output is identical for any thread count —
// the reference's own thread-safety-by-construction model.
int g_n_threads = 1;

template <class F>
void kt_for_eq(i64 n, const F& f) {
    int nt = (int)std::min<i64>(g_n_threads, n);
    if (nt <= 1) {
        for (i64 i = 0; i < n; ++i) f(i);
        return;
    }
    std::atomic<i64> next(0);
    auto worker = [&]() {
        for (;;) {
            i64 i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            f(i);
        }
    };
    vector<std::thread> ths;
    ths.reserve(nt - 1);
    for (int t = 0; t < nt - 1; ++t) ths.emplace_back(worker);
    worker();
    for (auto& th : ths) th.join();
}

// ---------------------------------------------------------------------
// options mirror (mem_opt_t, mapping/comp_seed.h:41-73)
struct CsOpt {
    i32 a, b, o_del, e_del, o_ins, e_ins;
    i32 pen_unpaired, pen_clip5, pen_clip3, w, zdrop;
    i64 max_mem_intv;
    i32 T, flag, min_seed_len, min_chain_weight, max_chain_extend;
    float split_factor;
    i32 split_width, max_occ, max_chain_gap;
    float mask_level, drop_ratio, XA_drop_ratio, mask_level_redun;
    float mapQ_coef_len;
    i32 mapQ_coef_fac;
    i32 max_ins, max_matesw, max_XA_hits, max_XA_hits_alt;
    int8_t mat[25];
};

constexpr i32 FLAG_PE = 0x2;
constexpr i32 FLAG_NOPAIRING = 0x4;
constexpr i32 FLAG_ALL = 0x8;
constexpr i32 FLAG_NO_MULTI = 0x10;
constexpr i32 FLAG_NO_RESCUE = 0x20;
constexpr i32 FLAG_REF_HDR = 0x100;
constexpr i32 FLAG_SOFTCLIP = 0x200;
constexpr i32 FLAG_PRIMARY5 = 0x800;
constexpr i32 FLAG_KEEP_SUPP_MAPQ = 0x1000;

// ---------------------------------------------------------------------
// ks_introsort replica (cstl/ksort.h:146-226): the permutation of equal
// keys feeds hash tie-breaking, so std::sort is not an option.
template <typename T, typename LT>
void insert_sort(T* s, T* t, LT lt) {
    for (T* i = s + 1; i < t; ++i)
        for (T* j = i; j > s && lt(*j, *(j - 1)); --j) std::swap(*j, *(j - 1));
}

template <typename T, typename LT>
void comb_sort(size_t n, T* a, LT lt) {
    const double shrink = 1.2473309501039786540366528676643;
    size_t gap = n;
    bool do_swap;
    do {
        if (gap > 2) {
            gap = (size_t)(gap / shrink);
            if (gap == 9 || gap == 10) gap = 11;
        }
        do_swap = false;
        for (T* i = a; i < a + n - gap; ++i) {
            T* j = i + gap;
            if (lt(*j, *i)) { std::swap(*i, *j); do_swap = true; }
        }
    } while (do_swap || gap > 2);
    if (gap != 1) insert_sort(a, a + n, lt);
}

template <typename T, typename LT>
void intro_sort(size_t n, T* a, LT lt) {
    if (n < 1) return;
    if (n == 2) {
        if (lt(a[1], a[0])) std::swap(a[0], a[1]);
        return;
    }
    int d = 2;
    while ((1ul << d) < n) ++d;
    struct Frame { T *left, *right; int depth; };
    vector<Frame> stack;
    stack.reserve(sizeof(size_t) * d + 2);
    T *s = a, *t = a + (n - 1);
    d <<= 1;
    for (;;) {
        if (s < t) {
            if (--d == 0) {
                comb_sort(t - s + 1, s, lt);
                t = s;
                continue;
            }
            T *i = s, *j = t, *k = i + ((j - i) >> 1) + 1;
            if (lt(*k, *i)) {
                if (lt(*k, *j)) k = j;
            } else
                k = lt(*j, *i) ? i : j;
            T rp = *k;
            if (k != t) std::swap(*k, *t);
            for (;;) {
                do ++i; while (lt(*i, rp));
                do --j; while (i <= j && lt(rp, *j));
                if (j <= i) break;
                std::swap(*i, *j);
            }
            std::swap(*i, *t);
            if (i - s > t - i) {
                if (i - s > 16) stack.push_back({s, i - 1, d});
                s = (t - i > 16) ? i + 1 : t;
            } else {
                if (t - i > 16) stack.push_back({i + 1, t, d});
                t = (i - s > 16) ? i - 1 : s;
            }
        } else {
            if (stack.empty()) {
                insert_sort(a, a + n, lt);
                return;
            }
            Frame f = stack.back();
            stack.pop_back();
            s = f.left; t = f.right; d = f.depth;
        }
    }
}

// ---------------------------------------------------------------------
static inline u64 wang_hash64(u64 key) {  // bwalib/utils.h:99
    key += ~(key << 32); key ^= key >> 22;
    key += ~(key << 13); key ^= key >> 8;
    key += key << 3;     key ^= key >> 15;
    key += ~(key << 27); key ^= key >> 31;
    return key;
}

// ---------------------------------------------------------------------
// reference metadata + pac access (FM_index/bntseq.c)
struct RefMeta {
    const u8* pac;
    i64 l_pac;
    int n_anns;
    const i64* ann_off;
    const i32* ann_len;
    const u8* ann_is_alt;
    const char* name_buf;       // concatenated, NUL separated
    vector<const char*> names;

    int pos2rid(i64 pos_f) const {  // bntseq.c:354
        if (pos_f >= l_pac) return -1;
        int lo = 0, hi = n_anns;
        while (lo < hi) {
            int mid = (lo + hi) >> 1;
            if (ann_off[mid] <= pos_f) lo = mid + 1; else hi = mid;
        }
        return lo - 1;
    }
    i64 depos(i64 pos, bool* is_rev) const {  // bntseq.h:87
        *is_rev = pos >= l_pac;
        return *is_rev ? (l_pac << 1) - 1 - pos : pos;
    }
    int intv2rid(i64 rb, i64 re) const {  // bntseq.c:370
        if (rb < l_pac && re > l_pac) return -2;
        bool rev;
        int rid_b = pos2rid(depos(rb, &rev));
        int rid_e = rb < re ? pos2rid(depos(re - 1, &rev)) : rid_b;
        return rid_b == rid_e ? rid_b : -1;
    }
    inline u8 get_base(i64 l) const { return pac[l >> 2] >> ((~l & 3) << 1) & 3; }
    // bns_get_seq (bntseq.c:403): window on one strand only
    void get_seq(i64 beg, i64 end, vector<u8>* out) const {
        out->clear();
        if (end < beg) std::swap(beg, end);
        if (end > l_pac << 1) end = l_pac << 1;
        if (beg < 0) beg = 0;
        if (beg >= l_pac || end <= l_pac) {
            out->reserve(end - beg);
            if (beg >= l_pac) {
                i64 beg_f = (l_pac << 1) - end, end_f = (l_pac << 1) - beg;
                for (i64 k = end_f - 1; k >= beg_f; --k)
                    out->push_back(3 - get_base(k));
            } else {
                for (i64 k = beg; k < end; ++k) out->push_back(get_base(k));
            }
        }
    }
    // bns_fetch_seq (bntseq.c:426)
    void fetch_seq(i64* beg, i64 mid, i64* end, int* rid,
                   vector<u8>* out) const {
        if (*end < *beg) std::swap(*beg, *end);
        bool rev;
        *rid = pos2rid(depos(mid, &rev));
        i64 far_beg = ann_off[*rid], far_end = far_beg + ann_len[*rid];
        if (rev) {
            i64 tmp = far_beg;
            far_beg = (l_pac << 1) - far_end;
            far_end = (l_pac << 1) - tmp;
        }
        if (*beg < far_beg) *beg = far_beg;
        if (*end > far_end) *end = far_end;
        get_seq(*beg, *end, out);
    }
};

// ---------------------------------------------------------------------
// DP kernels (host side): banded global NW with CIGAR (ksw_global2,
// bwalib/ksw.c:504-607) and plain local SW score (ksw.c:232-334).
constexpr i32 MINUS_INF = -0x40000000;

struct Cig { vector<u64> ops; };  // op | len<<4 packed like BAM

static void push_op(vector<u64>* c, int op, i64 len) {
    if (!c->empty() && (int)((*c)[c->size() - 1] & 0xf) == op)
        (*c)[c->size() - 1] += (u64)len << 4;
    else
        c->push_back((u64)len << 4 | op);
}

static i32 global_align(const CsOpt& o, int qlen, const u8* query, int tlen,
                        const u8* target, int w, vector<u64>* cigar) {
    const int8_t* mat = o.mat;
    i32 oe_del = o.o_del + o.e_del, oe_ins = o.o_ins + o.e_ins;
    int n_col = std::min(qlen, 2 * w + 1);
    vector<u8> z;
    if (cigar) z.assign((size_t)n_col * tlen, 0);
    vector<i32> H(qlen + 1), E(qlen + 1);
    H[0] = 0; E[0] = MINUS_INF;
    for (int j = 1; j <= qlen; ++j) {
        H[j] = j <= w ? -(o.o_ins + o.e_ins * j) : MINUS_INF;
        E[j] = MINUS_INF;
    }
    for (int i = 0; i < tlen; ++i) {
        int beg = i > w ? i - w : 0;
        int end = std::min(i + w + 1, qlen);
        i32 f = MINUS_INF;
        i32 h1 = beg == 0 ? -(o.o_del + o.e_del * (i + 1)) : MINUS_INF;
        const int8_t* q = mat + 5 * target[i];
        u8* zi = cigar ? z.data() + (size_t)i * n_col : nullptr;
        for (int j = beg; j < end; ++j) {
            i32 m = H[j], e = E[j];
            H[j] = h1;
            m += q[query[j]];
            u8 d = m >= e ? 0 : 1;
            i32 h = m >= e ? m : e;
            d = h >= f ? d : 2;
            h = h >= f ? h : f;
            h1 = h;
            i32 t = m - oe_del;
            e -= o.e_del;
            d |= e > t ? 1 << 2 : 0;
            e = e > t ? e : t;
            E[j] = e;
            t = m - oe_ins;
            f -= o.e_ins;
            d |= f > t ? 2 << 4 : 0;
            f = f > t ? f : t;
            if (zi) zi[j - beg] = d;
        }
        H[end] = h1;
        E[end] = MINUS_INF;
    }
    i32 score = H[qlen];
    if (cigar) {
        cigar->clear();
        int which = 0;
        int i = tlen - 1;
        int k = std::min(i + w + 1, qlen) - 1;
        vector<int> rev_ops;
        while (i >= 0 && k >= 0) {
            which = z[(size_t)i * n_col + (k - (i > w ? i - w : 0))] >>
                        (which << 1) & 3;
            if (which == 0) { rev_ops.push_back(0); --i; --k; }
            else if (which == 1) { rev_ops.push_back(2); --i; }
            else { rev_ops.push_back(1); --k; }
        }
        for (; i >= 0; --i) rev_ops.push_back(2);
        for (; k >= 0; --k) rev_ops.push_back(1);
        for (auto it = rev_ops.rbegin(); it != rev_ops.rend(); ++it)
            push_op(cigar, *it, 1);
    }
    return score;
}

static i32 local_sw_score(const CsOpt& o, int qlen, const u8* query,
                          int tlen, const u8* target) {
    i32 oe_del = o.o_del + o.e_del, oe_ins = o.o_ins + o.e_ins;
    vector<i32> H(qlen + 1, 0), E(qlen, 0);
    i32 best = 0;
    for (int i = 0; i < tlen; ++i) {
        const int8_t* q = o.mat + 5 * target[i];
        i32 f = 0, hdiag = H[0];
        H[0] = 0;
        for (int j = 0; j < qlen; ++j) {
            i32 m = hdiag + q[query[j]];
            hdiag = H[j + 1];
            i32 h = std::max({m, E[j], f, 0});
            H[j + 1] = h;
            best = std::max(best, h);
            E[j] = std::max(std::max(E[j] - o.e_del, h - oe_del), 0);
            f = std::max(std::max(f - o.e_ins, h - oe_ins), 0);
        }
    }
    return best;
}

// ---------------------------------------------------------------------
struct SeedC {
    i64 rbeg;
    i32 qbeg, len, score;
    i32 aln;  // alnreg slot created for this seed
};

struct ChainC {
    i64 pos;
    int rid;
    u8 is_alt;
    float frac_rep;
    i32 w, kept, first;
    vector<SeedC> seeds;
};

struct RegC {
    i64 rb, re;
    i32 qb, qe;
    int rid;
    i32 score, truesc, sub, alt_sc, csub, sub_n, w, seedcov;
    i32 secondary, secondary_all, seedlen0, n_comp;
    u8 is_alt;
    float frac_rep;
    u64 hash;
    int chain_idx;  // for seedcov
};

struct PairC {
    vector<u8> qs, rs;
    i32 h0;
    i32 read, regid;
    u8 pending;
    // metadata form: the device slices sequences itself from the read
    // matrix / packed reference (q0/r0 are the FIRST consumed positions;
    // rev means both run downward, i.e. a left extension)
    i32 q0 = 0, qlen = 0, rlen = 0;
    i64 r0 = 0;
    u8 rev = 0;
};

struct ReadState {
    vector<u8> query;
    vector<ChainC> chains;
    vector<RegC> regs;
    vector<vector<int>> srt;  // per chain: seed order by (score, idx)
    string sam;
};

struct Batch {
    CsOpt opt;
    RefMeta ref;
    vector<ReadState> reads;
    vector<PairC> left, right;
    int left_round = 0, right_round = 0;
    bool right_seeded = false;
    bool meta_mode = false;  // skip byte copies; export metadata only
};

static inline int cal_max_gap(const CsOpt& o, i32 qlen) {  // :415
    int l_del = (int)((double)(qlen * o.a - o.o_del) / o.e_del + 1.);
    int l_ins = (int)((double)(qlen * o.a - o.o_ins) / o.e_ins + 1.);
    int l = std::max(std::max(l_del, l_ins), 1);
    return std::min(l, o.w << 1);
}

static i32 chain_weight(const ChainC& c) {  // :205
    i64 end = 0; i32 w = 0;
    for (const auto& s : c.seeds) {
        if (s.qbeg >= end) w += s.len;
        else if (s.qbeg + s.len > end) w += s.qbeg + s.len - (i32)end;
        end = std::max(end, (i64)s.qbeg + s.len);
    }
    i32 tmp = w; w = 0; end = 0;
    for (const auto& s : c.seeds) {
        if (s.rbeg >= end) w += s.len;
        else if (s.rbeg + s.len > end) w += (i32)(s.rbeg + s.len - end);
        end = std::max(end, s.rbeg + s.len);
    }
    w = std::min(w, tmp);
    return std::min(w, (i32)((1 << 30) - 1));
}

// Faithful replica of the reference's chain B-tree (cstl/kbtree.h,
// KBTREE_INIT(chn, mem_chain_t, chain_cmp)).  Its internals are
// OUTPUT-VISIBLE, so an ordered-map approximation is not equivalent:
//  * kb_putp inserts an equal-pos key right after the FIRST equal key,
//    so duplicates sit in [first, then LIFO] order within a node;
//  * kb_intervalp's lower bound lands on whichever duplicate is
//    node-resident closest below the probe — which chain a seed is
//    tested against (test_and_merge) depends on that identity;
//  * the final chain array is the tree's in-order traversal;
//  * node capacity comes from KB_DEFAULT_SIZE=512 over the 40-byte
//    mem_chain_t: t = ((512-4-8)/(8+40)+1)>>1 = 5, so splits (which
//    reshuffle duplicate groups across nodes) happen from 10 chains up.
struct KbTreeChn {
    static const int T = 5;  // see derivation above
    struct Key { i64 pos; i32 idx; };
    struct Node { int is_internal, n; Key key[2 * T - 1];
                  Node* ptr[2 * T]; };
    Node* root;
    KbTreeChn() { root = alloc(0); }
    ~KbTreeChn() { del(root); }
    static Node* alloc(int internal) {
        Node* x = (Node*)calloc(1, sizeof(Node));
        x->is_internal = internal;
        return x;
    }
    static void del(Node* x) {
        if (!x) return;
        if (x->is_internal)
            for (int i = 0; i <= x->n; ++i) del(x->ptr[i]);
        free(x);
    }
    static int cmp(i64 a, i64 b) { return (b < a) - (a < b); }
    // __kb_getp_aux (kbtree.h:118-131), binary-search variant
    static int getp_aux(const Node* x, i64 pos, int* r) {
        int tr, *rr = r ? r : &tr, begin = 0, end = x->n;
        if (x->n == 0) return -1;
        while (begin < end) {
            int mid = (begin + end) >> 1;
            if (cmp(x->key[mid].pos, pos) < 0) begin = mid + 1;
            else end = mid;
        }
        if (begin == x->n) { *rr = 1; return x->n - 1; }
        if ((*rr = cmp(pos, x->key[begin].pos)) < 0) --begin;
        return begin;
    }
    // kb_intervalp's lower result (kbtree.h:152-167)
    const Key* intervalp(i64 pos) const {
        int r = 0;
        const Node* x = root;
        const Key* lower = nullptr;
        while (x) {
            int i = getp_aux(x, pos, &r);
            if (i >= 0 && r == 0) return &x->key[i];
            if (i >= 0) lower = &x->key[i];
            if (!x->is_internal) return lower;
            x = x->ptr[i + 1];
        }
        return lower;
    }
    void split(Node* x, int i, Node* y) {  // __kb_split (:175-190)
        Node* z = alloc(y->is_internal);
        z->n = T - 1;
        memcpy(z->key, y->key + T, sizeof(Key) * (T - 1));
        if (y->is_internal) memcpy(z->ptr, y->ptr + T,
                                   sizeof(Node*) * T);
        y->n = T - 1;
        memmove(x->ptr + i + 2, x->ptr + i + 1,
                sizeof(Node*) * (x->n - i));
        x->ptr[i + 1] = z;
        memmove(x->key + i + 1, x->key + i, sizeof(Key) * (x->n - i));
        x->key[i] = y->key[T - 1];
        ++x->n;
    }
    void putp_aux(Node* x, Key k) {  // __kb_putp_aux (:192-209)
        int i;
        if (!x->is_internal) {
            i = getp_aux(x, k.pos, nullptr);
            if (i != x->n - 1)
                memmove(x->key + i + 2, x->key + i + 1,
                        (x->n - i - 1) * sizeof(Key));
            x->key[i + 1] = k;
            ++x->n;
        } else {
            i = getp_aux(x, k.pos, nullptr) + 1;
            if (x->ptr[i]->n == 2 * T - 1) {
                split(x, i, x->ptr[i]);
                if (cmp(k.pos, x->key[i].pos) > 0) ++i;
            }
            putp_aux(x->ptr[i], k);
        }
    }
    void put(i64 pos, i32 idx) {  // kb_putp (:211-223)
        if (root->n == 2 * T - 1) {
            Node* r0 = root;
            root = alloc(1);
            root->ptr[0] = r0;
            split(root, 0, r0);
        }
        putp_aux(root, Key{pos, idx});
    }
    void traverse(const Node* x, vector<i32>* out) const {
        if (!x) return;
        for (int i = 0; i <= x->n; ++i) {
            if (x->is_internal) traverse(x->ptr[i], out);
            if (i < x->n) out->push_back(x->key[i].idx);
        }
    }
};

// chaining (mem_chain, bwamem.c:359-435 == comp_seed.cpp:241-295)
static void build_chains(Batch* B, ReadState* rs, i64 l_rep,
                         const i64* seeds, i64 n_seeds) {
    const CsOpt& o = B->opt;
    int l_query = (int)rs->query.size();
    if (l_query < o.min_seed_len) return;
    KbTreeChn tree;
    int n_chains = 0;
    vector<ChainC> built;  // in insertion order; reordered by traversal
    for (i64 si = 0; si < n_seeds; ++si) {
        SeedC s{seeds[3 * si], (i32)seeds[3 * si + 1],
                (i32)seeds[3 * si + 2], (i32)seeds[3 * si + 2], -1};
        int rid = B->ref.intv2rid(s.rbeg, s.rbeg + s.len);
        if (rid < 0) continue;
        bool to_add = n_chains == 0;
        if (!to_add) {
            const KbTreeChn::Key* lower = tree.intervalp(s.rbeg);
            bool merged = false;
            if (lower) {  // test_and_merge (:182-203)
                ChainC& c = built[lower->idx];
                const SeedC& last = c.seeds.back();
                i64 qend = last.qbeg + last.len, rend = last.rbeg + last.len;
                if (rid == c.rid) {
                    if (s.qbeg >= c.seeds[0].qbeg && s.qbeg + s.len <= qend &&
                        s.rbeg >= c.seeds[0].rbeg && s.rbeg + s.len <= rend) {
                        merged = true;  // contained
                    } else if (!((last.rbeg < B->ref.l_pac ||
                                  c.seeds[0].rbeg < B->ref.l_pac) &&
                                 s.rbeg >= B->ref.l_pac)) {
                        i64 x = s.qbeg - last.qbeg, y = s.rbeg - last.rbeg;
                        if (y >= 0 && x - y <= o.w && y - x <= o.w &&
                            x - last.len < o.max_chain_gap &&
                            y - last.len < o.max_chain_gap) {
                            c.seeds.push_back(s);
                            merged = true;
                        }
                    }
                }
            }
            to_add = !merged;
        }
        if (to_add) {
            ChainC c;
            c.pos = s.rbeg; c.rid = rid;
            c.is_alt = B->ref.ann_is_alt[rid];
            c.frac_rep = 0.f; c.w = 0; c.kept = 0; c.first = -1;
            c.seeds.push_back(s);
            built.push_back(std::move(c));
            tree.put(s.rbeg, n_chains++);
        }
    }
    auto& chains = rs->chains;
    vector<i32> order;
    tree.traverse(tree.root, &order);
    chains.reserve(order.size());
    for (i32 idx : order) chains.push_back(std::move(built[idx]));
    // repetition fraction (:271): l_rep — the union length of the
    // read's over-occurring match intervals — is precomputed (on device
    // by the seeder, or host-side from oracle matches), so the match
    // list itself never crosses the host link
    float frac = (float)l_rep / l_query;
    for (auto& c : chains) c.frac_rep = frac;
}

static void filter_chains(const CsOpt& o, vector<ChainC>* chains) {  // :297
    if (chains->empty()) return;
    vector<ChainC> a;
    a.reserve(chains->size());
    for (auto& c : *chains) {
        c.first = -1; c.kept = 0;
        c.w = chain_weight(c);
        if (c.w >= o.min_chain_weight) a.push_back(std::move(c));
    }
    if (a.empty()) { chains->clear(); return; }
    intro_sort(a.size(), a.data(),
               [](const ChainC& x, const ChainC& y) { return x.w > y.w; });
    int n = (int)a.size();
    auto cbeg = [](const ChainC& c) { return c.seeds[0].qbeg; };
    auto cend = [](const ChainC& c) {
        return c.seeds.back().qbeg + c.seeds.back().len;
    };
    vector<int> kept_idx{0};
    a[0].kept = 3;
    for (int i = 1; i < n; ++i) {
        bool large_ovlp = false, dropped = false;
        for (int j : kept_idx) {
            i32 b_max = std::max(cbeg(a[j]), cbeg(a[i]));
            i32 e_min = std::min(cend(a[j]), cend(a[i]));
            if (e_min > b_max && (!a[j].is_alt || a[i].is_alt)) {
                i32 li = cend(a[i]) - cbeg(a[i]);
                i32 lj = cend(a[j]) - cbeg(a[j]);
                i32 min_l = std::min(li, lj);
                if (e_min - b_max >= min_l * o.mask_level &&
                    min_l < o.max_chain_gap) {
                    large_ovlp = true;
                    if (a[j].first < 0) a[j].first = i;
                    if (a[i].w < a[j].w * o.drop_ratio &&
                        a[j].w - a[i].w >= o.min_seed_len << 1) {
                        dropped = true;
                        break;
                    }
                }
            }
        }
        if (!dropped) {
            kept_idx.push_back(i);
            a[i].kept = large_ovlp ? 2 : 3;
        }
    }
    for (int j : kept_idx)
        if (a[j].first >= 0) a[a[j].first].kept = 1;
    int k = 0, cut = n;
    for (int i = 0; i < n; ++i) {  // cap shadowed extensions (:342)
        if (a[i].kept == 0 || a[i].kept == 3) continue;
        if (++k >= o.max_chain_extend) { cut = i; break; }
    }
    for (int i = cut; i < n; ++i)
        if (a[i].kept < 3) a[i].kept = 0;
    chains->clear();
    for (auto& c : a)
        if (c.kept != 0) chains->push_back(std::move(c));
}

// mem_seed_sw + mem_flt_chained_seeds (:360-409)
static void filter_chained_seeds(Batch* B, ReadState* rs) {
    const CsOpt& o = B->opt;
    int l_query = (int)rs->query.size();
    double min_l = o.min_chain_weight
                       ? 1.1 * o.min_chain_weight
                       : 5.5 * std::log((double)l_query);
    int min_hsp = (int)(o.a * min_l + .499);
    if (min_l > 0.05 * l_query) return;
    vector<u8> rseq;
    for (auto& c : rs->chains) {
        vector<SeedC> keep;
        for (auto& s : c.seeds) {
            i32 sc = -1;
            if (s.len < 200) {
                i64 qb = std::max(s.qbeg - 50, 0);
                i64 qe = std::min<i64>(s.qbeg + s.len + 50, l_query);
                i64 rb = std::max<i64>(s.rbeg - 50, 0);
                i64 re = std::min(s.rbeg + s.len + 50, B->ref.l_pac << 1);
                i64 mid = (s.rbeg * 2 + s.len) >> 1;
                if (rb < B->ref.l_pac && B->ref.l_pac < re) {
                    if (mid < B->ref.l_pac) re = B->ref.l_pac;
                    else rb = B->ref.l_pac;
                }
                if (qe - qb < 200 && re - rb < 200) {
                    int rid;
                    B->ref.fetch_seq(&rb, mid, &re, &rid, &rseq);
                    sc = local_sw_score(o, (int)(qe - qb),
                                        rs->query.data() + qb,
                                        (int)rseq.size(), rseq.data());
                }
            }
            s.score = sc;
            if (s.score < 0 || s.score >= min_hsp) {
                s.score = s.score < 0 ? s.len * o.a : s.score;
                keep.push_back(s);
            }
        }
        c.seeds = std::move(keep);
    }
}

// pass 1 of the batched extension: alnreg slots + SeqPair emission
// (comp_seed.cpp:1358-1684)
constexpr i32 H0_SENT = -99;

static void emit_pairs(Batch* B, int read_idx) {
    const CsOpt& o = B->opt;
    ReadState& rs = B->reads[read_idx];
    int l_query = (int)rs.query.size();
    vector<u8> rseq;
    rs.srt.resize(rs.chains.size());
    for (size_t ci = 0; ci < rs.chains.size(); ++ci) {
        ChainC& c = rs.chains[ci];
        if (c.seeds.empty()) continue;
        i64 rmax0 = B->ref.l_pac << 1, rmax1 = 0;
        for (const auto& t : c.seeds) {
            i64 b = t.rbeg - (t.qbeg + cal_max_gap(o, t.qbeg));
            i64 e = t.rbeg + t.len +
                    ((l_query - t.qbeg - t.len) +
                     cal_max_gap(o, l_query - t.qbeg - t.len));
            rmax0 = std::min(rmax0, b);
            rmax1 = std::max(rmax1, e);
        }
        rmax0 = std::max<i64>(rmax0, 0);
        rmax1 = std::min(rmax1, B->ref.l_pac << 1);
        if (rmax0 < B->ref.l_pac && B->ref.l_pac < rmax1) {
            if (c.seeds[0].rbeg < B->ref.l_pac) rmax1 = B->ref.l_pac;
            else rmax0 = B->ref.l_pac;
        }
        int rid;
        B->ref.fetch_seq(&rmax0, c.seeds[0].rbeg, &rmax1, &rid, &rseq);

        int n = (int)c.seeds.size();
        vector<u64> keys(n);
        for (int i = 0; i < n; ++i)
            keys[i] = (u64)c.seeds[i].score << 32 | (u64)i;
        if (n > 1)
            intro_sort(n, keys.data(),
                       [](u64 x, u64 y) { return x < y; });
        auto& srt = rs.srt[ci];
        srt.resize(n);
        for (int i = 0; i < n; ++i) srt[i] = (i32)(u32)keys[i];

        for (int k = n - 1; k >= 0; --k) {
            SeedC& s = c.seeds[srt[k]];
            RegC a{};
            a.w = o.w; a.score = a.truesc = -1;
            a.rid = c.rid; a.frac_rep = c.frac_rep;
            a.seedlen0 = s.len; a.chain_idx = (int)ci;
            a.rb = a.re = H0_SENT; a.qb = a.qe = H0_SENT;
            a.secondary = a.secondary_all = -1;
            a.n_comp = 1;
            rs.regs.push_back(a);
            s.aln = (i32)rs.regs.size() - 1;
            RegC& ar = rs.regs.back();

            if (s.qbeg) {  // left extension pending
                PairC p;
                p.h0 = s.len * o.a;
                p.read = read_idx; p.regid = s.aln; p.pending = 1;
                p.rev = 1;
                p.q0 = s.qbeg - 1;
                p.qlen = s.qbeg;
                p.r0 = s.rbeg - 1;
                p.rlen = (i32)(s.rbeg - rmax0);
                if (!B->meta_mode) {
                    p.qs.resize(s.qbeg);
                    for (int i = 0; i < s.qbeg; ++i)
                        p.qs[i] = rs.query[s.qbeg - 1 - i];
                    i64 tmp = s.rbeg - rmax0;
                    p.rs.resize(tmp);
                    for (i64 i = 0; i < tmp; ++i) p.rs[i] = rseq[tmp - 1 - i];
                }
                B->left.push_back(std::move(p));
                ar.qb = s.qbeg; ar.rb = s.rbeg;
            } else {
                ar.score = ar.truesc = s.len * o.a;
                ar.qb = 0; ar.rb = s.rbeg;
            }
            if (s.qbeg + s.len != l_query) {  // right extension pending
                i64 qe = s.qbeg + s.len, re = s.rbeg + s.len - rmax0;
                PairC p;
                p.h0 = H0_SENT;
                p.read = read_idx; p.regid = s.aln; p.pending = 1;
                p.rev = 0;
                p.q0 = (i32)qe;
                p.qlen = (i32)(l_query - qe);
                p.r0 = rmax0 + re;
                p.rlen = (i32)(rmax1 - (rmax0 + re));
                if (!B->meta_mode) {
                    p.qs.assign(rs.query.begin() + qe, rs.query.end());
                    p.rs.assign(rseq.begin() + re, rseq.end());
                }
                B->right.push_back(std::move(p));
                ar.qe = (i32)qe; ar.re = rmax0 + re;
            } else {
                ar.qe = l_query;
                ar.re = s.rbeg + s.len;
                if (ar.rb != H0_SENT && ar.qb != H0_SENT) {
                    ar.seedcov = 0;
                    for (const auto& t : c.seeds)
                        if (t.qbeg >= ar.qb && t.qbeg + t.len <= ar.qe &&
                            t.rbeg >= ar.rb && t.rbeg + t.len <= ar.re)
                            ar.seedcov += t.len;
                }
            }
        }
    }
}

static void seedcov_of(ReadState* rs, RegC* a) {
    if (a->rb == H0_SENT || a->qb == H0_SENT || a->qe == H0_SENT ||
        a->re == H0_SENT)
        return;
    a->seedcov = 0;
    for (const auto& t : rs->chains[a->chain_idx].seeds)
        if (t.qbeg >= a->qb && t.qbeg + t.len <= a->qe && t.rbeg >= a->rb &&
            t.rbeg + t.len <= a->re)
            a->seedcov += t.len;
}

// acceptance / requeue after one DP round (comp_seed.cpp:1732-1767 left,
// :1949-1988 right)
static void apply_round(Batch* B, int side, i32 w, int last_round,
                        const i32* score, const i32* qle, const i32* tle,
                        const i32* gtle, const i32* gscore,
                        const i32* max_off) {
    const CsOpt& o = B->opt;
    auto& pairs = side == 0 ? B->left : B->right;
    i32 pen = side == 0 ? o.pen_clip5 : o.pen_clip3;
    i64 idx = 0;
    for (auto& p : pairs) {
        if (!p.pending) continue;
        i64 i = idx++;
        RegC& a = B->reads[p.read].regs[p.regid];
        i32 prev = a.score;
        a.score = score[i];
        if (a.score == prev || max_off[i] < (w >> 1) + (w >> 2) ||
            last_round) {
            if (side == 0) {
                if (gscore[i] <= 0 || gscore[i] <= a.score - pen) {
                    a.qb -= qle[i]; a.rb -= tle[i];
                    a.truesc = a.score;
                } else {
                    a.qb = 0; a.rb -= gtle[i];
                    a.truesc = gscore[i];
                }
            } else {
                if (gscore[i] <= 0 || gscore[i] <= a.score - pen) {
                    a.qe += qle[i]; a.re += tle[i];
                    a.truesc += a.score - p.h0;
                } else {
                    a.qe = (i32)B->reads[p.read].query.size();
                    a.re += gtle[i];
                    a.truesc += gscore[i] - p.h0;
                }
            }
            a.w = std::max(a.w, w);
            seedcov_of(&B->reads[p.read], &a);
            p.pending = 0;
        }
    }
}

// ordered purge of contained seeds (comp_seed.cpp:2141-2235)
static void purge_contained(Batch* B) {
    const CsOpt& o = B->opt;
    for (auto& rs : B->reads) {
        int l_query = (int)rs.query.size();
        vector<int> kept;
        for (size_t ci = 0; ci < rs.chains.size(); ++ci) {
            ChainC& c = rs.chains[ci];
            int n = (int)c.seeds.size();
            if (n == 0) continue;
            auto& srt = rs.srt[ci];
            vector<u8> purged(n, 0);
            for (int k = n - 1; k >= 0; --k) {
                SeedC& s = c.seeds[srt[k]];
                bool contained = false;
                for (int idx : kept) {
                    RegC& p = rs.regs[idx];
                    if (s.rbeg < p.rb || s.rbeg + s.len > p.re ||
                        s.qbeg < p.qb || s.qbeg + s.len > p.qe)
                        continue;
                    if (s.len - p.seedlen0 > .1 * l_query) continue;
                    i32 qd = s.qbeg - p.qb;
                    i64 rd = s.rbeg - p.rb;
                    i32 wlim = std::min(
                        cal_max_gap(o, (i32)std::min<i64>(qd, rd)), p.w);
                    if (qd - rd < wlim && rd - qd < wlim) {
                        contained = true;
                        break;
                    }
                    qd = p.qe - (s.qbeg + s.len);
                    rd = p.re - (s.rbeg + s.len);
                    wlim = std::min(
                        cal_max_gap(o, (i32)std::min<i64>(qd, rd)), p.w);
                    if (qd - rd < wlim && rd - qd < wlim) {
                        contained = true;
                        break;
                    }
                }
                if (contained) {
                    bool overlap = false;
                    for (int v = k + 1; v < n; ++v) {
                        if (purged[v]) continue;
                        const SeedC& t = c.seeds[srt[v]];
                        if (t.len < s.len * .95) continue;
                        if (s.qbeg <= t.qbeg &&
                            s.qbeg + s.len - t.qbeg >= s.len >> 2 &&
                            t.qbeg - s.qbeg != t.rbeg - s.rbeg) {
                            overlap = true;
                            break;
                        }
                        if (t.qbeg <= s.qbeg &&
                            t.qbeg + t.len - s.qbeg >= s.len >> 2 &&
                            s.qbeg - t.qbeg != s.rbeg - t.rbeg) {
                            overlap = true;
                            break;
                        }
                    }
                    if (!overlap) {
                        rs.regs[s.aln].qb = rs.regs[s.aln].qe = -1;
                        purged[k] = 1;
                        continue;
                    }
                }
                kept.push_back(s.aln);
            }
        }
    }
}

// gen_cigar (bwa_gen_cigar2, bwalib/bwa.c:147-233)
struct AlnOut {
    i64 pos = -1;
    int rid = -1;
    i32 flag = 0;
    u8 is_rev = 0, is_alt = 0;
    i32 mapq = 0, NM = -1;
    vector<u64> cigar;
    string MD;
    string XA;
    i32 score = 0, sub = -1, alt_sc = 0;
};

static bool gen_cigar(Batch* B, i32 w_, const u8* query0, int l_query,
                      i64 rb, i64 re, bool want_cigar, i32* score,
                      vector<u64>* cigar, i32* NM, string* MD) {
    const CsOpt& o = B->opt;
    i64 l_pac = B->ref.l_pac;
    if (l_query <= 0 || rb >= re || (rb < l_pac && re > l_pac)) return false;
    vector<u8> rseq;
    B->ref.get_seq(rb, re, &rseq);
    if ((i64)rseq.size() != re - rb) return false;
    vector<u8> qbuf(query0, query0 + l_query);
    if (rb >= l_pac) {
        std::reverse(qbuf.begin(), qbuf.end());
        std::reverse(rseq.begin(), rseq.end());
    }
    if (l_query == re - rb && w_ == 0) {  // no-gap shortcut (bwa.c:167)
        if (want_cigar) {
            cigar->clear();
            push_op(cigar, 0, l_query);
        }
        i32 sc = 0;
        for (int i = 0; i < l_query; ++i)
            sc += o.mat[rseq[i] * 5 + qbuf[i]];
        *score = sc;
    } else {
        int rlen = (int)(re - rb);
        int max_ins = (int)((double)(((l_query + 1) >> 1) * o.mat[0] -
                                     o.o_ins) / o.e_ins + 1.);
        int max_del = (int)((double)(((l_query + 1) >> 1) * o.mat[0] -
                                     o.o_del) / o.e_del + 1.);
        int max_gap = std::max(std::max(max_ins, max_del), 1);
        int w = (max_gap + std::abs(rlen - l_query) + 1) >> 1;
        w = std::min(w, (int)w_);
        w = std::max(w, std::abs(rlen - l_query) + 3);
        *score = global_align(o, l_query, qbuf.data(), rlen, rseq.data(), w,
                              want_cigar ? cigar : nullptr);
    }
    if (want_cigar) {  // NM + MD (bwa.c:195-224)
        i32 n_mm = 0, n_gap = 0;
        const char* int2base = rb < l_pac ? "ACGTN" : "TGCAN";
        i64 x = 0, y = 0;
        i32 u = 0;
        MD->clear();
        int n_cigar = (int)cigar->size();
        char tmp[32];
        for (int ki = 0; ki < n_cigar; ++ki) {
            int op = (int)((*cigar)[ki] & 0xf);
            i64 len = (i64)((*cigar)[ki] >> 4);
            if (op == 0) {
                for (i64 i = 0; i < len; ++i) {
                    if (qbuf[x + i] != rseq[y + i]) {
                        snprintf(tmp, sizeof(tmp), "%d", u);
                        *MD += tmp;
                        *MD += int2base[rseq[y + i]];
                        ++n_mm;
                        u = 0;
                    } else
                        ++u;
                }
                x += len; y += len;
            } else if (op == 2) {
                if (ki > 0 && ki < n_cigar - 1) {
                    snprintf(tmp, sizeof(tmp), "%d", u);
                    *MD += tmp;
                    *MD += '^';
                    for (i64 i = 0; i < len; ++i)
                        *MD += int2base[rseq[y + i]];
                    u = 0;
                    n_gap += (i32)len;
                }
                y += len;
            } else if (op == 1) {
                x += len;
                n_gap += (i32)len;
            }
        }
        snprintf(tmp, sizeof(tmp), "%d", u);
        *MD += tmp;
        *NM = n_mm + n_gap;
    }
    return true;
}

static i32 approx_mapq(const CsOpt& o, const RegC& a) {  // :686
    i32 sub = a.sub ? a.sub : o.min_seed_len * o.a;
    sub = std::max(a.csub, sub);
    if (sub >= a.score) return 0;
    i32 l = std::max((i64)(a.qe - a.qb), a.re - a.rb);
    double identity =
        1. - (double)(l * o.a - a.score) / (o.a + o.b) / l;
    i32 mapq;
    if (a.score == 0) {
        mapq = 0;
    } else if (o.mapQ_coef_len > 0) {
        double tmp = l < o.mapQ_coef_len ? 1. : o.mapQ_coef_fac / std::log(l);
        tmp *= identity * identity;
        mapq = (i32)(6.02 * (a.score - sub) / o.a * tmp * tmp + .499);
    } else {
        mapq = (i32)(30.0 * (1. - (double)sub / a.score) *
                         std::log(a.seedcov) + .499);
        mapq = identity < 0.95 ? (i32)(mapq * identity * identity + .499)
                               : mapq;
    }
    if (a.sub_n > 0) mapq -= (i32)(4.343 * std::log(a.sub_n + 1) + .499);
    mapq = std::min(mapq, 60);
    mapq = std::max(mapq, 0);
    return (i32)(mapq * (1. - a.frac_rep) + .499);
}

// mem_patch_reg (:599) + mem_sort_dedup_patch (:629)
static bool patch_reg(Batch* B, const u8* query, const RegC& a,
                      const RegC& b, i32* score_out, i32* w_out) {
    const CsOpt& o = B->opt;
    if (a.rb < B->ref.l_pac && b.rb >= B->ref.l_pac) return false;
    if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return false;
    i64 wv = (a.re - b.rb) - (a.qe - b.qb);
    wv = wv > 0 ? wv : -wv;
    double r = (double)(a.re - b.rb) / (b.re - a.rb) -
               (double)(a.qe - b.qb) / (b.qe - a.qb);
    r = r > 0. ? r : -r;
    if (a.re < b.rb || a.qe < b.qb) {
        if (wv > o.w << 1 || r >= 0.05) return false;
    } else if (wv > o.w << 2 || r >= 0.1) {
        return false;
    }
    i64 w = wv + a.w + b.w;
    w = std::min<i64>(w, o.w << 2);
    i32 score;
    vector<u64> cig;
    string md;
    i32 nm;
    if (!gen_cigar(B, (i32)w, query + a.qb, b.qe - a.qb, a.rb, b.re, false,
                   &score, &cig, &nm, &md))
        return false;
    int q_s = (int)((double)(b.qe - a.qb) /
                        ((b.qe - b.qb) + (a.qe - a.qb)) *
                        (b.score + a.score) + .499);
    int r_s = (int)((double)(b.re - a.rb) /
                        ((b.re - b.rb) + (a.re - a.rb)) *
                        (b.score + a.score) + .499);
    if ((double)score / std::max(q_s, r_s) < 0.90) return false;
    *score_out = score;
    *w_out = (i32)w;
    return true;
}

static void sort_dedup_patch(Batch* B, ReadState* rs,
                             bool patch = true) {
    const CsOpt& o = B->opt;
    auto& a = rs->regs;
    // drop purged / empty
    vector<RegC> live;
    live.reserve(a.size());
    for (auto& r : a)
        if (r.qe > r.qb) live.push_back(r);
    a = std::move(live);
    int n = (int)a.size();
    if (n <= 1) return;
    intro_sort(n, a.data(),
               [](const RegC& x, const RegC& y) { return x.re < y.re; });
    for (auto& r : a) r.n_comp = 1;
    for (int i = 1; i < n; ++i) {
        RegC* p = &a[i];
        if (p->rid != a[i - 1].rid ||
            p->rb >= a[i - 1].re + o.max_chain_gap)
            continue;
        for (int j = i - 1; j >= 0 && p->rid == a[j].rid &&
                            p->rb < a[j].re + o.max_chain_gap; --j) {
            RegC* q = &a[j];
            if (q->qe == q->qb) continue;
            i64 o_r = q->re - p->rb;
            i64 oq = q->qb < p->qb ? q->qe - p->qb : p->qe - q->qb;
            i64 mr = std::min(q->re - q->rb, p->re - p->rb);
            i64 mq = std::min(q->qe - q->qb, p->qe - p->qb);
            if (o_r > o.mask_level_redun * mr &&
                oq > o.mask_level_redun * mq) {
                if (p->score < q->score) {
                    p->qe = p->qb;
                    break;
                }
                q->qe = q->qb;
            } else if (q->rb < p->rb) {
                i32 score, w;
                if (patch &&
                    patch_reg(B, rs->query.data(), *q, *p, &score, &w)) {
                    p->n_comp += q->n_comp + 1;
                    p->seedcov = std::max(p->seedcov, q->seedcov);
                    p->sub = std::max(p->sub, q->sub);
                    p->csub = std::max(p->csub, q->csub);
                    p->qb = q->qb; p->rb = q->rb;
                    p->truesc = p->score = score;
                    p->w = w;
                    q->qb = q->qe;
                }
            }
        }
    }
    live.clear();
    for (auto& r : a)
        if (r.qe > r.qb) live.push_back(r);
    a = std::move(live);
    n = (int)a.size();
    intro_sort(n, a.data(), [](const RegC& x, const RegC& y) {
        return x.score > y.score ||
               (x.score == y.score &&
                (x.rb < y.rb || (x.rb == y.rb && x.qb < y.qb)));
    });
    for (int i = 1; i < n; ++i)
        if (a[i].score == a[i - 1].score && a[i].rb == a[i - 1].rb &&
            a[i].qb == a[i - 1].qb)
            a[i].qe = a[i].qb;
    live.clear();
    for (int i = 0; i < n; ++i)
        if (i == 0 || a[i].qe > a[i].qb) live.push_back(a[i]);
    a = std::move(live);
}

static void mark_primary_core(const CsOpt& o, RegC* a, int n) {  // :711
    i32 tmp = o.a + o.b;
    tmp = std::max(tmp, o.o_del + o.e_del);
    tmp = std::max(tmp, o.o_ins + o.e_ins);
    vector<int> z{0};
    for (int i = 1; i < n; ++i) {
        bool placed = false;
        for (int kzi = 0; kzi < (int)z.size(); ++kzi) {
            int j = z[kzi];
            i32 b_max = std::max(a[j].qb, a[i].qb);
            i32 e_min = std::min(a[j].qe, a[i].qe);
            if (e_min > b_max) {
                i32 min_l = std::min(a[i].qe - a[i].qb, a[j].qe - a[j].qb);
                if (e_min - b_max >= min_l * o.mask_level) {
                    if (a[j].sub == 0) a[j].sub = a[i].score;
                    if (a[j].score - a[i].score <= tmp &&
                        (a[j].is_alt || !a[i].is_alt))
                        ++a[j].sub_n;
                    a[i].secondary = j;
                    placed = true;
                    break;
                }
            }
        }
        if (!placed) z.push_back(i);
    }
}

constexpr i32 INT_MAX_C = 0x7fffffff;

static int mark_primary(const CsOpt& o, vector<RegC>* regs, i64 id) {  // :738
    int n = (int)regs->size();
    if (n == 0) return 0;
    RegC* a = regs->data();
    int n_pri = 0;
    for (int i = 0; i < n; ++i) {
        a[i].sub = a[i].alt_sc = 0;
        a[i].secondary = a[i].secondary_all = -1;
        a[i].hash = wang_hash64((u64)(id + i));
        if (!a[i].is_alt) ++n_pri;
    }
    intro_sort(n, a, [](const RegC& x, const RegC& y) {
        return x.score > y.score ||
               (x.score == y.score &&
                (x.is_alt < y.is_alt ||
                 (x.is_alt == y.is_alt && x.hash < y.hash)));
    });
    mark_primary_core(o, a, n);
    for (int i = 0; i < n; ++i) {
        a[i].secondary_all = i;
        if (!a[i].is_alt && a[i].secondary >= 0 &&
            a[i].secondary < n && a[a[i].secondary].is_alt)
            a[i].alt_sc = a[a[i].secondary].score;
    }
    if (n_pri < n) {
        vector<int> z(n);
        if (n_pri > 0)
            intro_sort(n, a, [](const RegC& x, const RegC& y) {
                return x.is_alt < y.is_alt ||
                       (x.is_alt == y.is_alt &&
                        (x.score > y.score ||
                         (x.score == y.score && x.hash < y.hash)));
            });
        for (int i = 0; i < n; ++i) z[a[i].secondary_all] = i;
        for (int i = 0; i < n; ++i) {
            if (a[i].secondary >= 0) {
                a[i].secondary_all = z[a[i].secondary];
                if (a[i].is_alt) a[i].secondary = INT_MAX_C;
            } else
                a[i].secondary_all = -1;
        }
        if (n_pri > 0) {
            for (int i = 0; i < n_pri; ++i) {
                a[i].sub = 0;
                a[i].secondary = -1;
            }
            mark_primary_core(o, a, n_pri);
        }
    } else {
        for (int i = 0; i < n; ++i) a[i].secondary_all = a[i].secondary;
    }
    return n_pri;
}

static void reorder_primary5(i32 T, vector<RegC>* regs) {  // :776
    int n_pri = 0, left_st = INT_MAX_C, left_k = -1;
    int n = (int)regs->size();
    RegC* a = regs->data();
    for (int k = 0; k < n; ++k)
        if (a[k].secondary < 0 && !a[k].is_alt && a[k].score >= T) ++n_pri;
    if (n_pri <= 1) return;
    for (int k = 0; k < n; ++k) {
        if (a[k].secondary >= 0 || a[k].is_alt || a[k].score < T) continue;
        if (a[k].qb < left_st) { left_st = a[k].qb; left_k = k; }
    }
    if (left_k == 0) return;
    std::swap(a[0], a[left_k]);
    for (int k = 1; k < n; ++k) {
        if (a[k].secondary == 0) a[k].secondary = left_k;
        else if (a[k].secondary == left_k) a[k].secondary = 0;
        if (a[k].secondary_all == 0) a[k].secondary_all = left_k;
        else if (a[k].secondary_all == left_k) a[k].secondary_all = 0;
    }
}

static int infer_bw(int l1, int l2, int score, int a, int q, int r) {  // :803
    if (l1 == l2 && l1 * a - score < (q + r - a) << 1) return 0;
    int w = (int)((double)(std::min(l1, l2) * a - score - q) / r + 2.);
    return std::max(w, std::abs(l1 - l2));
}

static AlnOut reg2aln(Batch* B, ReadState* rs, const RegC* ar) {  // :811
    const CsOpt& o = B->opt;
    AlnOut a;
    int l_query = (int)rs->query.size();
    if (!ar || ar->rb < 0 || ar->re < 0) {
        a.rid = -1; a.pos = -1; a.flag |= 0x4;
        a.NM = 0; a.sub = 0; a.score = 0;
        return a;
    }
    i32 qb = ar->qb, qe = ar->qe;
    i64 rb = ar->rb, re = ar->re;
    a.mapq = ar->secondary < 0 ? approx_mapq(o, *ar) : 0;
    if (ar->secondary >= 0) a.flag |= 0x100;
    int tmp = infer_bw(qe - qb, (int)(re - rb), ar->truesc, o.a, o.o_del,
                       o.e_del);
    int w2 = infer_bw(qe - qb, (int)(re - rb), ar->truesc, o.a, o.o_ins,
                      o.e_ins);
    w2 = std::max(w2, tmp);
    if (w2 > o.w) w2 = std::min(w2, ar->w);
    int i = 0;
    i32 last_sc = -(1 << 30), score = 0, NM = -1;
    for (;;) {
        w2 = std::min(w2, o.w << 2);
        gen_cigar(B, w2, rs->query.data() + qb, qe - qb, rb, re, true,
                  &score, &a.cigar, &NM, &a.MD);
        if (score == last_sc || w2 == o.w << 2) break;
        last_sc = score;
        w2 <<= 1;
        if (!(++i < 3 && score < ar->truesc - o.a)) break;
    }
    a.NM = NM;
    bool is_rev;
    i64 pos = B->ref.depos(rb < B->ref.l_pac ? rb : re - 1, &is_rev);
    a.is_rev = is_rev;
    if (!a.cigar.empty()) {  // squeeze edge deletions
        if ((a.cigar.front() & 0xf) == 2) {
            pos += a.cigar.front() >> 4;
            a.cigar.erase(a.cigar.begin());
        } else if ((a.cigar.back() & 0xf) == 2) {
            a.cigar.pop_back();
        }
    }
    if (qb != 0 || qe != l_query) {
        i64 clip5 = is_rev ? l_query - qe : qb;
        i64 clip3 = is_rev ? qb : l_query - qe;
        if (clip5) a.cigar.insert(a.cigar.begin(), (u64)clip5 << 4 | 3);
        if (clip3) a.cigar.push_back((u64)clip3 << 4 | 3);
    }
    a.rid = B->ref.pos2rid(pos);
    a.pos = pos - B->ref.ann_off[a.rid];
    a.score = ar->score;
    a.sub = std::max(ar->sub, ar->csub);
    a.is_alt = ar->is_alt;
    a.alt_sc = ar->alt_sc;
    return a;
}

static const char CIGCHR[] = "MIDSH";
static const char CIGCHR_N[] = "MIDSHN";
static const char B2A[] = "ACGTN";
static const char B2A_C[] = "TGCAN";

static void append_int(string* s, i64 v) {
    char buf[24];
    snprintf(buf, sizeof(buf), "%lld", (long long)v);
    *s += buf;
}

static void append_cigar(const CsOpt& o, const AlnOut& p, int which,
                         string* s) {  // add_cigar :892
    if (p.cigar.empty()) {
        *s += '*';
        return;
    }
    for (u64 cv : p.cigar) {
        int c = (int)(cv & 0xf);
        if (!(o.flag & FLAG_SOFTCLIP) && !p.is_alt && (c == 3 || c == 4))
            c = which ? 4 : 3;
        append_int(s, (i64)(cv >> 4));
        *s += CIGCHR[c];
    }
}

static i64 get_rlen(const vector<u64>& cigar) {  // bwa.c get_rlen
    i64 l = 0;
    for (u64 cv : cigar)
        if ((cv & 0xf) == 0 || (cv & 0xf) == 2) l += (i64)(cv >> 4);
    return l;
}

static void aln2sam(Batch* B, ReadState* rs, const char* name,
                    const char* qual, i64 qual_len, const char* comment,
                    const char* rg_id, int n, const vector<AlnOut>& list,
                    int which, string* str, const AlnOut* m_ = nullptr) {
    // mem_aln2sam (comp_seed.cpp:904-1024) incl. the PE mate fields
    const CsOpt& o = B->opt;
    AlnOut p = list[which];  // mutable copies: unmapped ends copy coords
    AlnOut m;
    bool has_m = m_ != nullptr;
    if (has_m) m = *m_;
    i32 flag = p.flag;
    flag |= has_m ? 0x1 : 0;
    flag |= p.rid < 0 ? 0x4 : 0;
    flag |= (has_m && m.rid < 0) ? 0x8 : 0;
    if (p.rid < 0 && has_m && m.rid >= 0) {
        p.rid = m.rid;
        p.pos = m.pos;
        p.is_rev = m.is_rev;
        p.cigar.clear();
    }
    if (has_m && m.rid < 0 && p.rid >= 0) {
        m.rid = p.rid;
        m.pos = p.pos;
        m.is_rev = p.is_rev;
        m.cigar.clear();
    }
    flag |= p.is_rev ? 0x10 : 0;
    flag |= (has_m && m.is_rev) ? 0x20 : 0;
    *str += name;
    *str += '\t';
    append_int(str, (flag & 0xffff) | ((flag & 0x10000) ? 0x100 : 0));
    if (p.rid >= 0) {
        *str += '\t';
        *str += B->ref.names[p.rid];
        *str += '\t';
        append_int(str, p.pos + 1);
        *str += '\t';
        append_int(str, p.mapq);
        *str += '\t';
        append_cigar(o, p, which, str);
    } else {
        *str += "\t*\t0\t0\t*";
    }
    *str += '\t';
    if (has_m && m.rid >= 0) {
        if (p.rid == m.rid)
            *str += '=';
        else
            *str += B->ref.names[m.rid];
        *str += '\t';
        append_int(str, m.pos + 1);
        *str += '\t';
        if (p.rid == m.rid) {
            i64 p0 = p.pos + (p.is_rev ? get_rlen(p.cigar) - 1 : 0);
            i64 p1 = m.pos + (m.is_rev ? get_rlen(m.cigar) - 1 : 0);
            if (m.cigar.empty() || p.cigar.empty())
                *str += '0';
            else
                append_int(str,
                           -(p0 - p1 + (p0 > p1 ? 1 : p0 < p1 ? -1 : 0)));
        } else {
            *str += '0';
        }
    } else {
        *str += "*\t0\t0";
    }
    *str += '\t';
    int l_seq = (int)rs->query.size();
    if (flag & 0x100) {
        *str += "*\t*";
    } else {
        int qb = 0, qe = l_seq;
        if (!p.cigar.empty() && which && !(o.flag & FLAG_SOFTCLIP) &&
            !p.is_alt) {
            int c0 = (int)(p.cigar.front() & 0xf);
            int c1 = (int)(p.cigar.back() & 0xf);
            if (!p.is_rev) {
                if (c0 == 3 || c0 == 4) qb += (int)(p.cigar.front() >> 4);
                if (c1 == 3 || c1 == 4) qe -= (int)(p.cigar.back() >> 4);
            } else {
                if (c0 == 3 || c0 == 4) qe -= (int)(p.cigar.front() >> 4);
                if (c1 == 3 || c1 == 4) qb += (int)(p.cigar.back() >> 4);
            }
        }
        if (!p.is_rev) {
            for (int i = qb; i < qe; ++i) *str += B2A[rs->query[i]];
            *str += '\t';
            if (qual_len > 0)
                str->append(qual + qb, qe - qb);
            else
                *str += '*';
        } else {
            for (int i = qe - 1; i >= qb; --i) *str += B2A_C[rs->query[i]];
            *str += '\t';
            if (qual_len > 0)
                for (int i = qe - 1; i >= qb; --i) *str += qual[i];
            else
                *str += '*';
        }
    }
    if (!p.cigar.empty()) {
        *str += "\tNM:i:";
        append_int(str, p.NM);
        *str += "\tMD:Z:";
        *str += p.MD;
    }
    if (has_m && !m.cigar.empty()) {
        *str += "\tMC:Z:";
        append_cigar(o, m, which, str);
    }
    if (p.score >= 0) {
        *str += "\tAS:i:";
        append_int(str, p.score);
    }
    if (p.sub >= 0) {
        *str += "\tXS:i:";
        append_int(str, p.sub);
    }
    if (rg_id && rg_id[0]) {
        *str += "\tRG:Z:";
        *str += rg_id;
    }
    if (!(flag & 0x100)) {
        bool has_other = false;
        for (int i = 0; i < n; ++i)
            if (i != which && !(list[i].flag & 0x100)) { has_other = true; break; }
        if (has_other) {
            *str += "\tSA:Z:";
            for (int i = 0; i < n; ++i) {
                const AlnOut& r = list[i];
                if (i == which || (r.flag & 0x100)) continue;
                *str += B->ref.names[r.rid];
                *str += ',';
                append_int(str, r.pos + 1);
                *str += ',';
                *str += r.is_rev ? '-' : '+';
                *str += ',';
                for (u64 cv : r.cigar) {
                    append_int(str, (i64)(cv >> 4));
                    *str += CIGCHR[cv & 0xf];
                }
                *str += ',';
                append_int(str, r.mapq);
                *str += ',';
                append_int(str, r.NM);
                *str += ';';
            }
        }
        if (p.alt_sc > 0) {
            char buf[48];
            snprintf(buf, sizeof(buf), "\tpa:f:%.3f",
                     (double)p.score / p.alt_sc);
            *str += buf;
        }
    }
    if (!p.XA.empty()) {
        *str += "\tXA:Z:";
        *str += p.XA;
    }
    if (comment && comment[0]) {
        *str += '\t';
        *str += comment;
    }
    // XR tag intentionally omitted here; handled when FLAG_REF_HDR set
    *str += '\n';
}

static int get_pri_idx(double xa_drop, const RegC* a, int n, int i) {
    int k = a[i].secondary_all;
    if (k >= 0 && a[i].score >= a[k].score * xa_drop) return k;
    return -1;
}

static void gen_alt(Batch* B, ReadState* rs, vector<string>* XA) {  // :1034
    const CsOpt& o = B->opt;
    int n = (int)rs->regs.size();
    XA->assign(n, string());
    vector<int> cnt(n, 0);
    vector<u8> has_alt(n, 0);
    int tot = 0;
    const RegC* a = rs->regs.data();
    for (int i = 0; i < n; ++i) {
        int r = get_pri_idx(o.XA_drop_ratio, a, n, i);
        if (r >= 0) {
            ++cnt[r];
            ++tot;
            if (a[i].is_alt) has_alt[r] = 1;
        }
    }
    if (tot == 0) return;
    for (int i = 0; i < n; ++i) {
        int r = get_pri_idx(o.XA_drop_ratio, a, n, i);
        if (r < 0) continue;
        if (cnt[r] > o.max_XA_hits_alt ||
            (!has_alt[r] && cnt[r] > o.max_XA_hits))
            continue;
        AlnOut t = reg2aln(B, rs, &rs->regs[i]);
        string& out = (*XA)[r];
        out += B->ref.names[t.rid];
        out += ',';
        out += t.is_rev ? '-' : '+';
        append_int(&out, t.pos + 1);
        out += ',';
        for (u64 cv : t.cigar) {
            append_int(&out, (i64)(cv >> 4));
            out += CIGCHR_N[cv & 0xf];
        }
        out += ',';
        append_int(&out, t.NM);
        out += ';';
    }
}

static void reg2sam(Batch* B, ReadState* rs, const char* name,
                    const char* qual, i64 qual_len, const char* comment,
                    const char* rg_id, i32 extra_flag = 0,
                    const AlnOut* m = nullptr) {  // :1079
    const CsOpt& o = B->opt;
    vector<string> XA;
    bool want_xa = !(o.flag & FLAG_ALL);
    if (want_xa) gen_alt(B, rs, &XA);
    vector<AlnOut> aa;
    int n = (int)rs->regs.size();
    for (int k = 0; k < n; ++k) {
        RegC* p = &rs->regs[k];
        if (p->score < o.T) continue;
        if (p->secondary >= 0 && (p->is_alt || !(o.flag & FLAG_ALL)))
            continue;
        if (p->secondary >= 0 && p->secondary < INT_MAX_C &&
            p->score < rs->regs[p->secondary].score * o.drop_ratio)
            continue;
        AlnOut q = reg2aln(B, rs, p);
        if (want_xa && !XA[k].empty()) q.XA = XA[k];
        q.flag |= extra_flag;
        if (p->secondary >= 0) q.sub = -1;
        if (!aa.empty() && p->secondary < 0)
            q.flag |= (o.flag & FLAG_NO_MULTI) ? 0x10000 : 0x800;
        if (!(o.flag & FLAG_KEEP_SUPP_MAPQ) && !aa.empty() && !p->is_alt &&
            q.mapq > aa[0].mapq)
            q.mapq = aa[0].mapq;
        aa.push_back(std::move(q));
    }
    rs->sam.clear();
    if (aa.empty()) {
        AlnOut t = reg2aln(B, rs, nullptr);
        t.flag |= extra_flag;
        vector<AlnOut> one;
        one.push_back(std::move(t));
        aln2sam(B, rs, name, qual, qual_len, comment, rg_id, 1, one, 0,
                &rs->sam, m);
    } else {
        for (int k = 0; k < (int)aa.size(); ++k)
            aln2sam(B, rs, name, qual, qual_len, comment, rg_id,
                    (int)aa.size(), aa, k, &rs->sam, m);
    }
}

// =======================================================================
// Paired-end pipeline (mapping/bwamem_pair.c)
// =======================================================================

constexpr double PE_MIN_RATIO = 0.8;
constexpr int PE_MIN_DIR_CNT = 10;
constexpr double PE_MIN_DIR_RATIO = 0.05;
constexpr double PE_OUTLIER_BOUND = 2.0;
constexpr double PE_MAPPING_BOUND = 3.0;
constexpr double PE_MAX_STDDEV = 4.0;

struct PeStat {  // mem_pestat_t
    int low = 0, high = 0;
    double avg = 0, std = 0;
    int failed = 0;
};

// orientation of a pair of hit coordinates (mem_infer_dir, bwamem_pair.c:23)
static inline int infer_dir(i64 l_pac, i64 b1, i64 b2, i64* dist) {
    int r1 = b1 >= l_pac, r2 = b2 >= l_pac;
    i64 p2 = r1 == r2 ? b2 : (l_pac << 1) - 1 - b2;
    *dist = p2 > b1 ? p2 - b1 : b1 - p2;
    return (r1 == r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// second-best score among alignments overlapping the best (cal_sub, :32)
static int cal_sub(const CsOpt& o, const vector<RegC>& r) {
    size_t j;
    for (j = 1; j < r.size(); ++j) {
        i32 b_max = std::max(r[j].qb, r[0].qb);
        i32 e_min = std::min(r[j].qe, r[0].qe);
        if (e_min > b_max) {
            i32 min_l = std::min(r[j].qe - r[j].qb, r[0].qe - r[0].qb);
            if (e_min - b_max >= min_l * o.mask_level) break;
        }
    }
    return j < r.size() ? r[j].score : o.min_seed_len * o.a;
}

// insert-size inference over the batch (mem_pestat, bwamem_pair.c:46-109)
static void pestat(Batch* B, PeStat pes[4]) {
    const CsOpt& o = B->opt;
    i64 l_pac = B->ref.l_pac;
    vector<u64> isize[4];
    for (size_t i = 0; i + 1 < B->reads.size(); i += 2) {
        auto& r0 = B->reads[i].regs;
        auto& r1 = B->reads[i + 1].regs;
        if (r0.empty() || r1.empty()) continue;
        if (cal_sub(o, r0) > PE_MIN_RATIO * r0[0].score) continue;
        if (cal_sub(o, r1) > PE_MIN_RATIO * r1[0].score) continue;
        if (r0[0].rid != r1[0].rid) continue;
        i64 is;
        int dir = infer_dir(l_pac, r0[0].rb, r1[0].rb, &is);
        if (is && is <= o.max_ins) isize[dir].push_back((u64)is);
    }
    fprintf(stderr,
            "[M::mem_pestat] # candidate unique pairs for (FF, FR, RF, RR):"
            " (%ld, %ld, %ld, %ld)\n", (long)isize[0].size(),
            (long)isize[1].size(), (long)isize[2].size(),
            (long)isize[3].size());
    for (int d = 0; d < 4; ++d) {
        PeStat* r = &pes[d];
        auto& q = isize[d];
        if ((int)q.size() < PE_MIN_DIR_CNT) {
            fprintf(stderr, "[M::mem_pestat] skip orientation %c%c as there"
                    " are not enough pairs\n", "FR"[d >> 1 & 1], "FR"[d & 1]);
            r->failed = 1;
            continue;
        }
        fprintf(stderr, "[M::mem_pestat] analyzing insert size distribution"
                " for orientation %c%c...\n", "FR"[d >> 1 & 1], "FR"[d & 1]);
        intro_sort((int)q.size(), q.data(),
                   [](u64 a, u64 b) { return a < b; });
        int p25 = (int)q[(size_t)(.25 * q.size() + .499)];
        int p50 = (int)q[(size_t)(.50 * q.size() + .499)];
        int p75 = (int)q[(size_t)(.75 * q.size() + .499)];
        r->low = (int)(p25 - PE_OUTLIER_BOUND * (p75 - p25) + .499);
        if (r->low < 1) r->low = 1;
        r->high = (int)(p75 + PE_OUTLIER_BOUND * (p75 - p25) + .499);
        fprintf(stderr, "[M::mem_pestat] (25, 50, 75) percentile: (%d, %d,"
                " %d)\n", p25, p50, p75);
        (void)p50;
        int x = 0;
        r->avg = 0;
        for (u64 v : q)
            if ((int)v >= r->low && (int)v <= r->high) r->avg += v, ++x;
        r->avg /= x;
        r->std = 0;
        for (u64 v : q)
            if ((int)v >= r->low && (int)v <= r->high)
                r->std += ((double)v - r->avg) * ((double)v - r->avg);
        r->std = sqrt(r->std / x);
        fprintf(stderr, "[M::mem_pestat] mean and std.dev: (%.2f, %.2f)\n",
                r->avg, r->std);
        r->low = (int)(p25 - PE_MAPPING_BOUND * (p75 - p25) + .499);
        r->high = (int)(p75 + PE_MAPPING_BOUND * (p75 - p25) + .499);
        if (r->low > r->avg - PE_MAX_STDDEV * r->std)
            r->low = (int)(r->avg - PE_MAX_STDDEV * r->std + .499);
        if (r->high < r->avg + PE_MAX_STDDEV * r->std)
            r->high = (int)(r->avg + PE_MAX_STDDEV * r->std + .499);
        if (r->low < 1) r->low = 1;
    }
    size_t mx = 0;
    for (int d = 0; d < 4; ++d) mx = std::max(mx, isize[d].size());
    for (int d = 0; d < 4; ++d)
        if (!pes[d].failed && isize[d].size() < mx * PE_MIN_DIR_RATIO)
            pes[d].failed = 1;
}

// ---- local SW with the exact ksw_u8/i16 result contract (ksw.c:111-334):
// score/te/qe plus the second-best row max outside the best-score window.
struct KswR {
    int score = 0, te = -1, qe = -1, score2 = -1, te2 = -1, tb = -1, qb = -1;
};

static KswR ksw_core(int qlen, const u8* query, int tlen, const u8* target,
                     const CsOpt& o, int minsc, int endsc) {
    KswR r;
    if (qlen <= 0 || tlen <= 0) return r;
    vector<i32> H(qlen, 0), E(qlen, 0), Hmax(qlen, 0);
    vector<u64> b;
    int gmax = 0, te = -1;
    i32 oe_del = o.o_del + o.e_del, oe_ins = o.o_ins + o.e_ins;
    for (int i = 0; i < tlen; ++i) {
        const auto* ma = &o.mat[5 * target[i]];
        i32 f = 0, h_diag = 0, imax = 0;
        for (int j = 0; j < qlen; ++j) {
            i32 hm = h_diag + ma[query[j]];
            h_diag = H[j];
            i32 h = std::max(std::max(hm, E[j]), std::max(f, 0));
            imax = std::max(imax, h);
            E[j] = std::max(std::max(E[j] - o.e_del, h - oe_del), 0);
            f = std::max(std::max(f - o.e_ins, h - oe_ins), 0);
            H[j] = h;
        }
        if (imax >= minsc) {  // row-max runs for the 2nd-best score
            if (b.empty() || (i32)b.back() + 1 != i)
                b.push_back((u64)imax << 32 | (u32)i);
            else if ((int)(b.back() >> 32) < imax)
                b.back() = (u64)imax << 32 | (u32)i;
        }
        if (imax > gmax) {
            gmax = imax;
            te = i;
            Hmax = H;
            if (gmax >= endsc) break;
        }
    }
    r.score = gmax;
    r.te = te;
    int mx = -1;
    for (int j = 0; j < qlen; ++j)
        if (Hmax[j] > mx) mx = Hmax[j], r.qe = j;
    if (!b.empty()) {
        int max_mat = 0;
        for (int i = 0; i < 25; ++i) max_mat = std::max(max_mat,
                                                        (int)o.mat[i]);
        int i0 = (r.score + max_mat - 1) / max_mat;
        int low = te - i0, high = te + i0;
        for (u64 v : b) {
            int e = (i32)(u32)v;
            if ((e < low || e > high) && (int)(v >> 32) > r.score2)
                r.score2 = (int)(v >> 32), r.te2 = e;
        }
    }
    return r;
}

constexpr int KSW_XSTOP = 0x20000;
constexpr int KSW_XSUBO = 0x40000;
constexpr int KSW_XSTART = 0x80000;

static KswR ksw_align2_eq(int qlen, const u8* query, int tlen,
                          const u8* target, const CsOpt& o, int xtra) {
    // ksw_align2 (ksw.c:343-365): forward pass, then a reverse pass over
    // the prefixes ending at (qe, te) to recover the start coordinates
    int minsc = (xtra & KSW_XSUBO) ? (xtra & 0xffff) : 0x10000;
    int endsc = (xtra & KSW_XSTOP) ? (xtra & 0xffff) : 0x10000;
    KswR r = ksw_core(qlen, query, tlen, target, o, minsc, endsc);
    if (!(xtra & KSW_XSTART) ||
        ((xtra & KSW_XSUBO) && r.score < (xtra & 0xffff)))
        return r;
    vector<u8> qr(query, query + qlen), tr(target, target + tlen);
    std::reverse(qr.begin(), qr.begin() + r.qe + 1);
    std::reverse(tr.begin(), tr.begin() + r.te + 1);
    KswR rr = ksw_core(r.qe + 1, qr.data(), tlen, tr.data(), o,
                       0x10000, r.score);
    if (r.score == rr.score) {
        r.tb = r.te - rr.te;
        r.qb = r.qe - rr.qe;
    }
    return r;
}

// mate rescue (mem_matesw, bwamem_pair.c:111-180)
static int matesw(Batch* B, const PeStat pes[4], const RegC* a,
                  ReadState* mate) {
    const CsOpt& o = B->opt;
    i64 l_pac = B->ref.l_pac;
    int l_ms = (int)mate->query.size();
    const u8* ms = mate->query.data();
    int skip[4], n = 0;
    for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed ? 1 : 0;
    for (auto& m : mate->regs) {
        i64 dist;
        int r = infer_dir(l_pac, a->rb, m.rb, &dist);
        if (dist >= pes[r].low && dist <= pes[r].high) skip[r] = 1;
    }
    if (skip[0] + skip[1] + skip[2] + skip[3] == 4) return 0;
    for (int r = 0; r < 4; ++r) {
        if (skip[r]) continue;
        int is_rev = (r >> 1) != (r & 1);
        int is_larger = !(r >> 1);
        vector<u8> rev;
        const u8* seq = ms;
        if (is_rev) {
            rev.resize(l_ms);
            for (int i = 0; i < l_ms; ++i)
                rev[l_ms - 1 - i] = ms[i] < 4 ? 3 - ms[i] : 4;
            seq = rev.data();
        }
        i64 rb, re;
        if (!is_rev) {
            rb = is_larger ? a->rb + pes[r].low : a->rb - pes[r].high;
            re = (is_larger ? a->rb + pes[r].high : a->rb - pes[r].low) +
                 l_ms;
        } else {
            rb = (is_larger ? a->rb + pes[r].low : a->rb - pes[r].high) -
                 l_ms;
            re = is_larger ? a->rb + pes[r].high : a->rb - pes[r].low;
        }
        if (rb < 0) rb = 0;
        if (re > l_pac << 1) re = l_pac << 1;
        int rid = -1;
        vector<u8> ref;
        if (rb < re) B->ref.fetch_seq(&rb, (rb + re) >> 1, &re, &rid, &ref);
        if (a->rid == rid && re - rb >= o.min_seed_len) {
            int xtra = KSW_XSUBO | KSW_XSTART |
                       (o.min_seed_len * o.a);
            KswR aln = ksw_align2_eq(l_ms, seq, (int)(re - rb), ref.data(),
                                     o, xtra);
            if (aln.score >= o.min_seed_len && aln.qb >= 0) {
                RegC b{};
                b.rid = a->rid;
                b.is_alt = a->is_alt;
                b.qb = is_rev ? l_ms - (aln.qe + 1) : aln.qb;
                b.qe = is_rev ? l_ms - aln.qb : aln.qe + 1;
                b.rb = is_rev ? (l_pac << 1) - (rb + aln.te + 1)
                              : rb + aln.tb;
                b.re = is_rev ? (l_pac << 1) - (rb + aln.tb)
                              : rb + aln.te + 1;
                // remaining fields stay zero, matching the reference's
                // zero-initialized mem_alnreg_t (bwamem_pair.c:153)
                b.score = aln.score;
                b.csub = aln.score2;
                b.secondary = -1;
                b.chain_idx = -1;
                b.seedcov = (i32)(std::min<i64>(b.re - b.rb,
                                                b.qe - b.qb) >> 1);
                // sorted insert by score (bwamem_pair.c:166-173)
                size_t ins = 0;
                while (ins < mate->regs.size() &&
                       mate->regs[ins].score >= b.score)
                    ++ins;
                mate->regs.insert(mate->regs.begin() + ins, b);
            }
            ++n;
        }
        if (n) sort_dedup_patch(B, mate, /*patch=*/false);
    }
    return n;
}

// pair scoring (mem_pair, bwamem_pair.c:183-243)
static int mem_pair_eq(Batch* B, const PeStat pes[4], ReadState* rs0,
                       ReadState* rs1, i64 id, int* sub, int* n_sub,
                       int z[2], const int n_pri[2]) {
    const CsOpt& o = B->opt;
    i64 l_pac = B->ref.l_pac;
    struct P64 { u64 x, y; };
    vector<P64> v, u;
    ReadState* rr[2] = {rs0, rs1};
    for (int r = 0; r < 2; ++r)
        for (int i = 0; i < n_pri[r]; ++i) {
            const RegC& e = rr[r]->regs[i];
            u64 x = e.rb < l_pac ? (u64)e.rb
                                 : (u64)((l_pac << 1) - 1 - e.rb);
            x = (u64)e.rid << 32 | (x - (u64)B->ref.ann_off[e.rid]);
            u64 y = (u64)(u32)e.score << 32 | (u64)i << 2 |
                    (u64)(e.rb >= l_pac) << 1 | (u64)r;
            v.push_back({x, y});
        }
    intro_sort((int)v.size(), v.data(), [](const P64& a, const P64& b) {
        return a.x < b.x || (a.x == b.x && a.y < b.y);
    });
    int y[4] = {-1, -1, -1, -1};
    for (size_t i = 0; i < v.size(); ++i) {
        for (int r = 0; r < 2; ++r) {
            int dir = r << 1 | (int)(v[i].y >> 1 & 1);
            if (pes[dir].failed) continue;
            int which = r << 1 | ((int)(v[i].y & 1) ^ 1);
            if (y[which] < 0) continue;
            for (int k = y[which]; k >= 0; --k) {
                if ((int)(v[k].y & 3) != which) continue;
                i64 dist = (i64)v[i].x - (i64)v[k].x;
                if (dist > pes[dir].high) break;
                if (dist < pes[dir].low) continue;
                double ns = (dist - pes[dir].avg) / pes[dir].std;
                int q = (int)((v[i].y >> 32) + (v[k].y >> 32) +
                              .721 * log(2. * erfc(fabs(ns) * M_SQRT1_2)) *
                                  o.a + .499);
                if (q < 0) q = 0;
                u64 py = (u64)k << 32 | (u32)i;
                u64 px = (u64)(u32)q << 32 |
                         (wang_hash64(py ^ (u64)id << 8) & 0xffffffffULL);
                u.push_back({px, py});
            }
        }
        y[v[i].y & 3] = (int)i;
    }
    int ret = 0;
    *sub = 0;
    *n_sub = 0;
    if (!u.empty()) {
        int tmp = std::max(o.a + o.b,
                           std::max(o.o_del + o.e_del, o.o_ins + o.e_ins));
        intro_sort((int)u.size(), u.data(), [](const P64& a, const P64& b) {
            return a.x < b.x || (a.x == b.x && a.y < b.y);
        });
        size_t i = u.back().y >> 32, k = u.back().y & 0xffffffffULL;
        z[v[i].y & 1] = (int)((v[i].y << 32) >> 34);
        z[v[k].y & 1] = (int)((v[k].y << 32) >> 34);
        ret = (int)(u.back().x >> 32);
        *sub = u.size() > 1 ? (int)(u[u.size() - 2].x >> 32) : 0;
        for (int j = (int)u.size() - 2; j >= 0; --j)
            if (*sub - (int)(u[j].x >> 32) <= tmp) ++*n_sub;
    }
    return ret;
}

static inline int raw_mapq(int diff, int a) {
    return (int)(6.02 * diff / a + .499);
}

// full PE output for one pair (mem_sam_pe, bwamem_pair.c:250-393)
static int sam_pe(Batch* B, const PeStat pes[4], i64 id, ReadState* rs0,
                  ReadState* rs1, const char* names[2],
                  const char* quals[2], const i64 qual_lens[2],
                  const char* comments[2], const char* rg_id) {
    const CsOpt& o = B->opt;
    ReadState* rr[2] = {rs0, rs1};
    int n = 0, z[2] = {0, 0}, n_pri[2];
    i32 extra_flag = 1;
    AlnOut h[2];
    if (!(o.flag & FLAG_NO_RESCUE)) {
        // snapshot both candidate lists BEFORE any rescue mutates regs
        vector<RegC> b[2];
        for (int i = 0; i < 2; ++i)
            for (auto& reg : rr[i]->regs)
                if (reg.score >= rr[i]->regs[0].score - o.pen_unpaired)
                    b[i].push_back(reg);
        for (int i = 0; i < 2; ++i)
            for (int j = 0; j < (int)b[i].size() && j < o.max_matesw; ++j)
                n += matesw(B, pes, &b[i][j], rr[!i]);
    }
    n_pri[0] = mark_primary(o, &rs0->regs, id << 1 | 0);
    n_pri[1] = mark_primary(o, &rs1->regs, id << 1 | 1);
    if (o.flag & FLAG_PRIMARY5) {
        reorder_primary5(o.T, &rs0->regs);
        reorder_primary5(o.T, &rs1->regs);
    }
    bool paired = false;
    int osc = 0, subo = 0, n_sub = 0;
    if (!(o.flag & FLAG_NOPAIRING) && n_pri[0] && n_pri[1]) {
        osc = mem_pair_eq(B, pes, rs0, rs1, id, &subo, &n_sub, z, n_pri);
        if (osc > 0) {
            // bail out when an end still has multiple good primary hits
            bool is_multi = false;
            for (int i = 0; i < 2 && !is_multi; ++i)
                for (int j = 1; j < n_pri[i]; ++j)
                    if (rr[i]->regs[j].secondary < 0 &&
                        rr[i]->regs[j].score >= o.T) {
                        is_multi = true;
                        break;
                    }
            if (!is_multi) paired = true;
        }
    }
    if (paired) {
        int score_un = rs0->regs[0].score + rs1->regs[0].score -
                       o.pen_unpaired;
        subo = std::max(subo, score_un);
        int q_pe = raw_mapq(osc - subo, o.a);
        if (n_sub > 0) q_pe -= (int)(4.343 * log(n_sub + 1) + .499);
        if (q_pe < 0) q_pe = 0;
        if (q_pe > 60) q_pe = 60;
        q_pe = (int)(q_pe * (1. - .5 * (rs0->regs[0].frac_rep +
                                        rs1->regs[0].frac_rep)) + .499);
        int q_se[2];
        if (osc > score_un) {  // paired alignment preferred
            for (int i = 0; i < 2; ++i) {
                RegC* c = &rr[i]->regs[z[i]];
                if (c->secondary >= 0) {
                    c->sub = rr[i]->regs[c->secondary].score;
                    c->secondary = -2;
                }
                q_se[i] = approx_mapq(o, *c);
            }
            q_se[0] = q_se[0] > q_pe ? q_se[0]
                      : q_pe < q_se[0] + 40 ? q_pe : q_se[0] + 40;
            q_se[1] = q_se[1] > q_pe ? q_se[1]
                      : q_pe < q_se[1] + 40 ? q_pe : q_se[1] + 40;
            extra_flag |= 2;
            q_se[0] = std::min(q_se[0],
                               raw_mapq(rr[0]->regs[z[0]].score -
                                        rr[0]->regs[z[0]].csub, o.a));
            q_se[1] = std::min(q_se[1],
                               raw_mapq(rr[1]->regs[z[1]].score -
                                        rr[1]->regs[z[1]].csub, o.a));
        } else {
            z[0] = z[1] = 0;
            q_se[0] = approx_mapq(o, rs0->regs[0]);
            q_se[1] = approx_mapq(o, rs1->regs[0]);
        }
        for (int i = 0; i < 2; ++i) {  // secondary/primary switcheroo
            auto& a = rr[i]->regs;
            int k = a[z[i]].secondary_all;
            if (k >= 0 && k < n_pri[i]) {
                for (auto& r : a)
                    if (r.secondary_all == k) r.secondary_all = z[i];
                a[k].secondary_all = z[i];
                a[z[i]].secondary_all = -1;
            }
        }
        vector<string> XA[2];
        if (!(o.flag & FLAG_ALL)) {
            gen_alt(B, rs0, &XA[0]);
            gen_alt(B, rs1, &XA[1]);
        }
        vector<AlnOut> aa[2];
        for (int i = 0; i < 2; ++i) {
            h[i] = reg2aln(B, rr[i], &rr[i]->regs[z[i]]);
            h[i].mapq = q_se[i];
            h[i].flag |= (0x40 << i) | extra_flag;
            if (!XA[i].empty() && !XA[i][z[i]].empty())
                h[i].XA = XA[i][z[i]];
            aa[i].push_back(h[i]);
            if (n_pri[i] < (int)rr[i]->regs.size()) {  // ALT supplementary
                RegC* p = &rr[i]->regs[n_pri[i]];
                if (p->score < o.T || p->secondary >= 0 || !p->is_alt)
                    continue;
                AlnOut g = reg2aln(B, rr[i], p);
                g.flag |= 0x800 | (0x40 << i) | extra_flag;
                if (!XA[i].empty() && !XA[i][n_pri[i]].empty())
                    g.XA = XA[i][n_pri[i]];
                aa[i].push_back(std::move(g));
            }
        }
        for (int i = 0; i < 2; ++i) {
            rr[i]->sam.clear();
            for (int k = 0; k < (int)aa[i].size(); ++k)
                aln2sam(B, rr[i], names[i], quals[i], qual_lens[i],
                        comments[i], rg_id, (int)aa[i].size(), aa[i], k,
                        &rr[i]->sam, &h[!i]);
        }
        return n;
    }
    // no pairing: emit both ends as (possibly) unpaired with mate info
    for (int i = 0; i < 2; ++i) {
        int which = -1;
        auto& a = rr[i]->regs;
        if (!a.empty()) {
            if (a[0].score >= o.T)
                which = 0;
            else if (n_pri[i] < (int)a.size() &&
                     a[n_pri[i]].score >= o.T)
                which = n_pri[i];
        }
        h[i] = reg2aln(B, rr[i], which >= 0 ? &a[which] : nullptr);
    }
    if (!(o.flag & FLAG_NOPAIRING) && h[0].rid == h[1].rid &&
        h[0].rid >= 0 && !rs0->regs.empty() && !rs1->regs.empty()) {
        i64 dist;
        int d = infer_dir(B->ref.l_pac, rs0->regs[0].rb, rs1->regs[0].rb,
                          &dist);
        if (!pes[d].failed && dist >= pes[d].low && dist <= pes[d].high)
            extra_flag |= 2;
    }
    reg2sam(B, rs0, names[0], quals[0], qual_lens[0], comments[0], rg_id,
            0x41 | extra_flag, &h[1]);
    reg2sam(B, rs1, names[1], quals[1], qual_lens[1], comments[1], rg_id,
            0x81 | extra_flag, &h[0]);
    return n;
}

}  // namespace

// =======================================================================
// C ABI
extern "C" {

void* cs_batch_create(const CsOpt* opt, const u8* pac, i64 l_pac,
                      const i64* ann_off, const i32* ann_len,
                      const u8* ann_is_alt, i32 n_anns,
                      const char* name_buf,
                      i32 n_reads, const u8* query_buf, const i64* query_off,
                      const i64* l_rep,
                      const i64* seed_flat, const i64* seed_off,
                      i32 meta_mode) {
    Batch* B = new Batch();
    B->opt = *opt;
    B->meta_mode = meta_mode != 0;
    B->ref.pac = pac;
    B->ref.l_pac = l_pac;
    B->ref.n_anns = n_anns;
    B->ref.ann_off = ann_off;
    B->ref.ann_len = ann_len;
    B->ref.ann_is_alt = ann_is_alt;
    B->ref.name_buf = name_buf;
    const char* np = name_buf;
    for (int i = 0; i < n_anns; ++i) {
        B->ref.names.push_back(np);
        np += strlen(np) + 1;
    }
    B->reads.resize(n_reads);
    // per-read chaining/filtering fans out over threads (the kt_for over
    // read tiles, comp_seed.cpp:2541-2548); emit_pairs stays serial below
    // so the SeqPair order — which fixes the DP batch layout — is
    // independent of the thread count
    kt_for_eq(n_reads, [&](i64 r) {
        ReadState& rs = B->reads[r];
        rs.query.assign(query_buf + query_off[r], query_buf + query_off[r + 1]);
        build_chains(B, &rs, l_rep[r],
                     seed_flat + 3 * seed_off[r],
                     seed_off[r + 1] - seed_off[r]);
        const char* dr = getenv("DUMP_READ");
        if (dr && atoi(dr) == r) {
            fprintf(stderr, "LREP read=%d l_rep=%lld\n", (int)r,
                    (long long)l_rep[r]);
            for (i64 si = seed_off[r]; si < seed_off[r + 1]; ++si)
                fprintf(stderr, "SEED rbeg=%lld qbeg=%lld len=%lld\n",
                        (long long)seed_flat[3 * si],
                        (long long)seed_flat[3 * si + 1],
                        (long long)seed_flat[3 * si + 2]);
            fprintf(stderr, "CHAINS read=%d n=%zu (pre-flt)\n", r,
                    rs.chains.size());
            for (size_t ci = 0; ci < rs.chains.size(); ++ci)
                for (size_t sj = 0; sj < rs.chains[ci].seeds.size(); ++sj)
                    fprintf(stderr, "  C%zu S%zu rbeg=%lld qbeg=%d len=%d"
                            " score=%d\n", ci, sj,
                            (long long)rs.chains[ci].seeds[sj].rbeg,
                            rs.chains[ci].seeds[sj].qbeg,
                            rs.chains[ci].seeds[sj].len,
                            rs.chains[ci].seeds[sj].score);
        }
        filter_chains(B->opt, &rs.chains);
        if (dr && atoi(dr) == r) {
            fprintf(stderr, "CHAINS read=%d n=%zu (post-flt)\n", r,
                    rs.chains.size());
            for (size_t ci = 0; ci < rs.chains.size(); ++ci)
                for (size_t sj = 0; sj < rs.chains[ci].seeds.size(); ++sj)
                    fprintf(stderr, "  C%zu S%zu rbeg=%lld qbeg=%d len=%d"
                            " score=%d\n", ci, sj,
                            (long long)rs.chains[ci].seeds[sj].rbeg,
                            rs.chains[ci].seeds[sj].qbeg,
                            rs.chains[ci].seeds[sj].len,
                            rs.chains[ci].seeds[sj].score);
        }
        filter_chained_seeds(B, &rs);
    });
    for (int r = 0; r < n_reads; ++r) emit_pairs(B, r);
    return B;
}

void cs_set_threads(i32 n) { g_n_threads = n > 0 ? n : 1; }

i64 cs_pending_pairs(void* h, i32 side) {
    Batch* B = (Batch*)h;
    auto& pairs = side == 0 ? B->left : B->right;
    i64 n = 0;
    for (auto& p : pairs) n += p.pending;
    return n;
}

// fill caller buffers with pending pairs; returns count.  qoff/roff have
// n+1 entries.  h0 for right pairs reads the current left-extended score.
i64 cs_export_pairs(void* h, i32 side, u8* qbuf, i64* qoff, u8* rbuf,
                    i64* roff, i32* h0) {
    Batch* B = (Batch*)h;
    auto& pairs = side == 0 ? B->left : B->right;
    if (side == 1 && !B->right_seeded) {
        for (auto& p : pairs)
            p.h0 = B->reads[p.read].regs[p.regid].score;  // :1918-1923
        B->right_seeded = true;
    }
    i64 n = 0, qo = 0, ro = 0;
    qoff[0] = roff[0] = 0;
    for (auto& p : pairs) {
        if (!p.pending) continue;
        memcpy(qbuf + qo, p.qs.data(), p.qs.size());
        memcpy(rbuf + ro, p.rs.data(), p.rs.size());
        qo += p.qs.size();
        ro += p.rs.size();
        h0[n] = p.h0;
        ++n;
        qoff[n] = qo;
        roff[n] = ro;
    }
    return n;
}

// metadata export: qmeta rows (read, q0, qlen, rev); rmeta rows
// (r0, rlen).  Same pending/right-h0 contract as cs_export_pairs.
// prev (optional) receives the reg's current score — the `prev` of the
// round-0 acceptance test (comp_seed.cpp:1737), needed when the band-
// retry decision runs on device (cs_apply_dual).
i64 cs_export_pair_meta(void* h, i32 side, i32* qmeta, i64* rmeta,
                        i32* h0, i32* prev) {
    Batch* B = (Batch*)h;
    auto& pairs = side == 0 ? B->left : B->right;
    if (side == 1 && !B->right_seeded) {
        for (auto& p : pairs)
            p.h0 = B->reads[p.read].regs[p.regid].score;  // :1918-1923
        B->right_seeded = true;
    }
    i64 n = 0;
    for (auto& p : pairs) {
        if (!p.pending) continue;
        qmeta[4 * n] = p.read;
        qmeta[4 * n + 1] = p.q0;
        qmeta[4 * n + 2] = p.qlen;
        qmeta[4 * n + 3] = p.rev;
        rmeta[2 * n] = p.r0;
        rmeta[2 * n + 1] = p.rlen;
        h0[n] = p.h0;
        if (prev) prev[n] = B->reads[p.read].regs[p.regid].score;
        ++n;
    }
    return n;
}

// apply BOTH band rounds at once: the device already ran round 0,
// the acceptance test, and (for rejected lanes) round 1 at 2*w0
// (ops/bsw.py::bsw_meta_dual); rnd[i] is the accepted round index, so
// every pair finalizes here with w = w0 << rnd[i].  Semantically equal
// to apply_round(rnd 0) then apply_round(rnd 1, last) in sequence.
void cs_apply_dual(void* h, i32 side, i32 w0, const i32* score,
                   const i32* qle, const i32* tle, const i32* gtle,
                   const i32* gscore, const i32* rnd) {
    Batch* B = (Batch*)h;
    const CsOpt& o = B->opt;
    auto& pairs = side == 0 ? B->left : B->right;
    i32 pen = side == 0 ? o.pen_clip5 : o.pen_clip3;
    i64 idx = 0;
    for (auto& p : pairs) {
        if (!p.pending) continue;
        i64 i = idx++;
        i32 w = w0 << rnd[i];
        RegC& a = B->reads[p.read].regs[p.regid];
        a.score = score[i];
        if (side == 0) {
            if (gscore[i] <= 0 || gscore[i] <= a.score - pen) {
                a.qb -= qle[i]; a.rb -= tle[i];
                a.truesc = a.score;
            } else {
                a.qb = 0; a.rb -= gtle[i];
                a.truesc = gscore[i];
            }
        } else {
            if (gscore[i] <= 0 || gscore[i] <= a.score - pen) {
                a.qe += qle[i]; a.re += tle[i];
                a.truesc += a.score - p.h0;
            } else {
                a.qe = (i32)B->reads[p.read].query.size();
                a.re += gtle[i];
                a.truesc += gscore[i] - p.h0;
            }
        }
        a.w = std::max(a.w, w);
        seedcov_of(&B->reads[p.read], &a);
        p.pending = 0;
    }
}

void cs_apply_round(void* h, i32 side, i32 w, i32 last_round,
                    const i32* score, const i32* qle, const i32* tle,
                    const i32* gtle, const i32* gscore, const i32* max_off) {
    apply_round((Batch*)h, side, w, last_round, score, qle, tle, gtle,
                gscore, max_off);
}

void cs_finalize(void* h, i64 n_processed, const char* name_buf,
                 const i64* name_off, const char* qual_buf,
                 const i64* qual_off, const char* comment_buf,
                 const i64* comment_off, const char* rg_id) {
    Batch* B = (Batch*)h;
    purge_contained(B);
    // per-read finalize is independent (worker2 SE, bwamem.c:1308-1317)
    kt_for_eq((i64)B->reads.size(), [&](i64 r) {
        ReadState& rs = B->reads[r];
        sort_dedup_patch(B, &rs);
        for (auto& p : rs.regs)
            if (p.rid >= 0 && B->ref.ann_is_alt[p.rid]) p.is_alt = 1;
        mark_primary(B->opt, &rs.regs, n_processed + (i64)r);
        if (B->opt.flag & FLAG_PRIMARY5) reorder_primary5(B->opt.T, &rs.regs);
        string name(name_buf + name_off[r],
                    name_buf + name_off[r + 1]);
        i64 ql = qual_off ? qual_off[r + 1] - qual_off[r] : 0;
        const char* qual = qual_off ? qual_buf + qual_off[r] : nullptr;
        string comment;
        if (comment_off && comment_off[r + 1] > comment_off[r])
            comment.assign(comment_buf + comment_off[r],
                           comment_buf + comment_off[r + 1]);
        reg2sam(B, &rs, name.c_str(), qual, ql,
                comment.empty() ? nullptr : comment.c_str(), rg_id);
    });
}

// paired-end finalize: dedup/patch per read, batch insert-size stats,
// then mate rescue + pairing + PE SAM per consecutive read pair
// (worker2 PE branch, mapping/bwamem.c:1308-1324 + bwamem_pair.c).
// pes_override: 20 doubles (4 x failed,low,high,avg,std) or NULL.
void cs_finalize_pe(void* h, i64 n_processed, const char* name_buf,
                    const i64* name_off, const char* qual_buf,
                    const i64* qual_off, const char* comment_buf,
                    const i64* comment_off, const char* rg_id,
                    const double* pes_override) {
    Batch* B = (Batch*)h;
    purge_contained(B);
    kt_for_eq((i64)B->reads.size(), [&](i64 r) {
        ReadState& rs = B->reads[r];
        sort_dedup_patch(B, &rs);
        for (auto& p : rs.regs)
            if (p.rid >= 0 && B->ref.ann_is_alt[p.rid]) p.is_alt = 1;
    });
    PeStat pes[4];
    if (pes_override) {
        for (int d = 0; d < 4; ++d) {
            pes[d].failed = (int)pes_override[5 * d];
            pes[d].low = (int)pes_override[5 * d + 1];
            pes[d].high = (int)pes_override[5 * d + 2];
            pes[d].avg = pes_override[5 * d + 3];
            pes[d].std = pes_override[5 * d + 4];
        }
    } else {
        pestat(B, pes);
    }
    vector<string> names(B->reads.size());
    for (size_t r = 0; r < B->reads.size(); ++r)
        names[r].assign(name_buf + name_off[r], name_buf + name_off[r + 1]);
    // odd trailing read: the reference's n>>1 worker count (bwamem.c:1362)
    // silently emits no record for it; we match that but warn on stderr
    if (B->reads.size() & 1)
        fprintf(stderr,
                "[W::cs_finalize_pe] odd number of reads in PE batch; "
                "the last read gets no alignment record\n");
    // pairs are independent (worker2 PE branch, bwamem.c:1318-1323)
    kt_for_eq((i64)(B->reads.size() / 2), [&](i64 p) {
        size_t r = (size_t)p * 2;
        const char* nm[2] = {names[r].c_str(), names[r + 1].c_str()};
        const char* ql[2] = {nullptr, nullptr};
        i64 qlen[2] = {0, 0};
        if (qual_off) {
            ql[0] = qual_buf + qual_off[r];
            ql[1] = qual_buf + qual_off[r + 1];
            qlen[0] = qual_off[r + 1] - qual_off[r];
            qlen[1] = qual_off[r + 2] - qual_off[r + 1];
        }
        string cm[2];
        const char* cmp[2] = {nullptr, nullptr};
        if (comment_off) {
            for (int i = 0; i < 2; ++i)
                if (comment_off[r + i + 1] > comment_off[r + i]) {
                    cm[i].assign(comment_buf + comment_off[r + i],
                                 comment_buf + comment_off[r + i + 1]);
                    cmp[i] = cm[i].c_str();
                }
        }
        sam_pe(B, pes, (n_processed >> 1) + (i64)(r >> 1),
               &B->reads[r], &B->reads[r + 1], nm, ql, qlen, cmp, rg_id);
    });
}

i64 cs_sam_len(void* h, i32 read) {
    return (i64)((Batch*)h)->reads[read].sam.size();
}

void cs_sam_copy(void* h, i32 read, char* out) {
    Batch* B = (Batch*)h;
    memcpy(out, B->reads[read].sam.data(), B->reads[read].sam.size());
}

// bulk variants: one call for the whole batch (per-read ctypes calls
// cost ~1.5 us each, which dominates at 16k+ reads/chunk)
i64 cs_sam_total(void* h, i64* offsets) {
    Batch* B = (Batch*)h;
    i64 acc = 0;
    offsets[0] = 0;
    for (size_t r = 0; r < B->reads.size(); ++r) {
        acc += (i64)B->reads[r].sam.size();
        offsets[r + 1] = acc;
    }
    return acc;
}

void cs_sam_copy_all(void* h, char* out) {
    Batch* B = (Batch*)h;
    char* p = out;
    for (auto& rd : B->reads) {
        memcpy(p, rd.sam.data(), rd.sam.size());
        p += rd.sam.size();
    }
}

i64 cs_pair_buf_sizes(void* h, i32 side, i64* max_q, i64* max_r) {
    Batch* B = (Batch*)h;
    auto& pairs = side == 0 ? B->left : B->right;
    i64 n = 0, qs = 0, rsz = 0;
    for (auto& p : pairs) {
        if (!p.pending) continue;
        ++n;
        qs += (i64)p.qs.size();
        rsz += (i64)p.rs.size();
    }
    *max_q = qs;
    *max_r = rsz;
    return n;
}

void cs_batch_destroy(void* h) { delete (Batch*)h; }

}  // extern "C"
