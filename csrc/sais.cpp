// SA-IS suffix-array construction (Nong-Zhang-Chan induced sorting),
// 64-bit indices throughout so whole-genome scales (hg19 forward+reverse
// = 6.2 G positions) fit in host RAM (~9-10 bytes/char peak).
//
// Role: the scalable counterpart of the reference's three BWT builders
// (FM_index/is.c SA-IS <=50 Mbp, bwt_gen.c BWT-SW incremental, rope.c
// RB2): one algorithm, linear time, covering every genome size the host
// memory allows.  Differentially tested against the numpy
// prefix-doubling builder (compseed/index/suffix.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;

template <typename TChar>
void sais_core(const TChar* T, i64* SA, i64 n, i64 K) {
    // T has length n and ends with a unique smallest sentinel T[n-1]=0.
    std::vector<uint8_t> t(n);  // 1 = S-type, 0 = L-type
    t[n - 1] = 1;
    for (i64 i = n - 2; i >= 0; --i)
        t[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && t[i + 1])) ? 1 : 0;
    auto is_lms = [&](i64 i) { return i > 0 && t[i] && !t[i - 1]; };

    std::vector<i64> bkt(K + 1);
    auto bucket_ends = [&](bool end) {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (i64 i = 0; i < n; ++i) ++bkt[T[i]];
        i64 sum = 0;
        for (i64 c = 0; c <= K; ++c) {
            sum += bkt[c];
            bkt[c] = end ? sum : sum - bkt[c];
        }
    };

    auto induce = [&]() {
        // L-type left-to-right
        bucket_ends(false);
        for (i64 i = 0; i < n; ++i) {
            i64 j = SA[i] - 1;
            if (SA[i] > 0 && !t[j]) SA[bkt[T[j]]++] = j;
        }
        // S-type right-to-left
        bucket_ends(true);
        for (i64 i = n - 1; i >= 0; --i) {
            i64 j = SA[i] - 1;
            if (SA[i] > 0 && t[j]) SA[--bkt[T[j]]] = j;
        }
    };

    // stage 1: place LMS suffixes at their bucket ends, induce a first
    // (LMS-substring) order
    std::memset(SA, -1, sizeof(i64) * n);
    bucket_ends(true);
    for (i64 i = 1; i < n; ++i)
        if (is_lms(i)) SA[--bkt[T[i]]] = i;
    induce();

    // stage 2: name LMS substrings in sorted order
    i64 n1 = 0;
    for (i64 i = 0; i < n; ++i)
        if (is_lms(SA[i])) SA[n1++] = SA[i];
    std::memset(SA + n1, -1, sizeof(i64) * (n - n1));
    i64* s1 = SA + n1;                  // names live in the upper half
    i64 name = 0, prev = -1;
    for (i64 i = 0; i < n1; ++i) {
        i64 pos = SA[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (i64 d = 0;; ++d) {
                if (T[pos + d] != T[prev + d] ||
                    t[pos + d] != t[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    // both LMS (equal substrings end together) -> equal
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) {
            ++name;
            prev = pos;
        }
        s1[pos >> 1] = name - 1;        // pos/2 is unique per LMS
    }
    // compact the names into a reduced string (in LMS text order)
    i64 m = 0;
    for (i64 i = n1; i < n; ++i)
        if (SA[i] >= 0) SA[n1 + m++] = SA[i];
    // now SA[n1 .. n1+n1) is the reduced string s1 of length n1

    if (name < n1) {                    // names repeat: recurse
        sais_core<i64>(SA + n1, SA, n1, name - 1);
    } else {                            // names unique: direct inverse
        for (i64 i = 0; i < n1; ++i) SA[SA[n1 + i]] = i;
    }

    // stage 3: map the sorted reduced suffixes back to LMS positions
    // (reuse the upper half to hold LMS positions in text order)
    i64* p1 = SA + n1;
    i64 k = 0;
    for (i64 i = 1; i < n; ++i)
        if (is_lms(i)) p1[k++] = i;
    for (i64 i = 0; i < n1; ++i) SA[i] = p1[SA[i]];
    // final induced sort from the exactly-sorted LMS order
    std::memset(SA + n1, -1, sizeof(i64) * (n - n1));
    bucket_ends(true);
    for (i64 i = n1 - 1; i >= 0; --i) {
        i64 j = SA[i];
        SA[i] = -1;
        SA[--bkt[T[j]]] = j;
    }
    induce();
}

}  // namespace

extern "C" {

// Suffix array of s[0..n) (+ virtual sentinel smaller than all chars).
// sa must have n+1 slots; sa[0] == n on return.  Alphabet: s values in
// [0, k).  Returns 0 on success.
int cs_sais_u8(const uint8_t* s, i64 n, i64 k, i64* sa) {
    if (n == 0) {
        sa[0] = 0;
        return 0;
    }
    std::vector<uint8_t> T(n + 1);
    for (i64 i = 0; i < n; ++i) T[i] = (uint8_t)(s[i] + 1);
    T[n] = 0;
    sais_core<uint8_t>(T.data(), sa, n + 1, k);
    return 0;
}

}  // extern "C"
