// Broad-phase level-2 hit detection (K4) for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes level 2 in plain jnp
// (smplifyx_tpu/ops/collision.py, the per-block [Phs, 8j, 8ti, 8tj] masks
// of its build), and the port's plain version
// (ops/collision.py::level2_hits_reference) builds [B, Phs, 8, 8, 8] bool
// masks, one per A-side block, through some thirty elementwise kernels
// each.  At B = 256, Phs = 4096 every mask is 512 M bytes, and level 2 took
// 90% of a broad phase's device time.  K4 gives the same bits in one pass.
//
// Per lane b and slot r of level 1's survivors (the superblock pair
// si = si_h[b, r], sj = sj_h[b, r]), bit i*8+j of hit[b, r] is set iff
// mb[b, r, i*8+j] is set and some triangle pair (ti, tj) of A-block
// si*8+i and B-block sj*8+j passes
//   rank order    (si*8+i)*8+ti < (sj*8+j)*8+tj
//   AABB overlap  bmin_k <= amax_k and bmax_k >= amin_k, k = x, y, z
//   part filter   (with parts) none of sa == sb, pa == sb, pb == sa, nor
//                 an ignored part pair (p, q) as (sa, sb) or (sb, sa),
// with the plain version's f32 comparisons, so the bits are equal.  The
// table is the plain version's blk_tab8 [B, ns, 8 * Cb * 8]: per
// superblock, per block i, per column k (min x, y, z, max x, y, z, then
// part and parent with parts: Cb = 8, else 6), the 8 triangles.
//
// Bound on an H100 SXM: bytes.  The work is comparisons: at the benchmark
// mesh (F = 20,908) a lane's live slots hold ~17,000 block pairs, 64
// triangle pairs each at ~12 operations, 3.4e9 operations at B = 256.
// The bytes are mb, si, sj and hit (0.15 GB at B = 256, Phs = 4096) and
// the table (0.17 GB), read once from device memory: ~0.1 ms at
// 3.35 TB/s.  A live slot reads its two superblock rows again from L2
// (4 KB), which a lane's rows (0.7 MB) stay in while its slots run.
//
// Design: one warp per slot, eight slots per block, no block waiting on
// another.  The warp reads the slot's 64 mask bytes as two ballots; a slot
// with no block pair (a third or more of them at the benchmark mesh: the
// padding slots past level 1's survivors) writes 64 zeros and ends, where
// the plain version computes every slot.  A live slot stages the blocks
// its pairs touch, of both superblock rows, into shared memory (16-byte
// loads; a block's stride padded so that blocks start in other banks),
// with a part-pair bitmask per triangle (bit e: the part is p_e, bit 16+e:
// q_e, the halves swapped on the B side, so an ignored pair is one AND).
// The work is spread as (block pair, ti) units over the warp's 32 threads,
// eight units per pair, each testing its A triangle against the 8 B
// triangles without branches: a slot with few pairs (seven on average)
// still keeps the warp busy.  A ballot per round gathers the pairs' bits,
// and the warp writes its 64 output bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // slots per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_IGN = 16;           // ignored part pairs (bits 0-15, 16-31)
constexpr unsigned FULL = 0xffffffffu;

struct IgnPairs {
    int n;
    float p[MAX_IGN];
    float q[MAX_IGN];
};

template <bool PARTS>
struct K4Shape {
    static constexpr int CB = PARTS ? 8 : 6;          // table columns
    static constexpr int COLS = PARTS ? CB + 1 : CB;  // + part-pair mask
    static constexpr int S = 8 * (COLS | 1);          // staged block stride
    static constexpr int SUPER = 8 * S;               // staged superblock
    static constexpr int ROW = 8 * CB * 8;            // table superblock row
};

template <bool PARTS>
__global__ void __launch_bounds__(THREADS)
k4_level2_hits(const float* __restrict__ tab, const long long* __restrict__ si_h,
               const long long* __restrict__ sj_h,
               const uint8_t* __restrict__ mb, uint8_t* __restrict__ hit,
               long long rows, int Phs, int ns, IgnPairs ign) {
    using K = K4Shape<PARTS>;
    constexpr int CB = K::CB, S = K::S;
    __shared__ __align__(16) float stage[WARPS][2][K::SUPER];
    __shared__ uint8_t pos[WARPS][64];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * WARPS + w;
    if (row >= rows) return;
    const uint8_t* m = mb + row * 64;
    uint8_t* out = hit + row * 64;
    const unsigned lo = __ballot_sync(FULL, m[lane] != 0);
    const unsigned hi = __ballot_sync(FULL, m[32 + lane] != 0);
    const long long si = si_h[row], sj = sj_h[row];
    if ((lo | hi) == 0 || si < 0 || si >= ns || sj < 0 || sj >= ns) {
        out[lane] = 0;
        out[32 + lane] = 0;
        return;
    }
    // The blocks the slot's pairs touch: A-block i where row i of the 8x8
    // mask has a bit, B-block j where column j has one.
    unsigned need_a = 0, need_b = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const unsigned byte = ((i < 4 ? lo : hi) >> (8 * (i & 3))) & 0xffu;
        need_a |= (byte != 0) << i;
        need_b |= byte;
    }
    const long long b = row / Phs;
    const float4* row_a = reinterpret_cast<const float4*>(tab + (b * ns + si) * K::ROW);
    const float4* row_b = reinterpret_cast<const float4*>(tab + (b * ns + sj) * K::ROW);
    for (int q = lane; q < 2 * K::ROW / 4; q += 32) {
        const int side = q / (K::ROW / 4), e = q % (K::ROW / 4);
        const int i = e / (2 * CB), k = (e / 2) % CB, t0 = (e & 1) * 4;
        if (((side ? need_b : need_a) >> i) & 1)
            *reinterpret_cast<float4*>(&stage[w][side][i * S + k * 8 + t0]) =
                __ldg((side ? row_b : row_a) + e);
    }
    __syncwarp();
    if (PARTS) {
        for (int e = lane; e < 128; e += 32) {
            const int side = e >> 6, i = (e >> 3) & 7, t = e & 7;
            if (!(((side ? need_b : need_a) >> i) & 1)) continue;
            float* blk = &stage[w][side][i * S];
            const float part = blk[(CB - 2) * 8 + t];
            unsigned bits = 0;
            for (int x = 0; x < ign.n; ++x) {
                const unsigned is_p = part == ign.p[x], is_q = part == ign.q[x];
                bits |= (side ? is_q : is_p) << x;
                bits |= (side ? is_p : is_q) << (MAX_IGN + x);
            }
            blk[CB * 8 + t] = __uint_as_float(bits);
        }
    }
    // The positions of the set bits, in order.
    const unsigned below = (1u << lane) - 1u;
    if ((lo >> lane) & 1) pos[w][__popc(lo & below)] = lane;
    if ((hi >> lane) & 1) pos[w][__popc(lo) + __popc(hi & below)] = 32 + lane;
    __syncwarp();

    const int units = (__popc(lo) + __popc(hi)) * 8;
    const int ra0 = (int)si * 64, rb0 = (int)sj * 64;
    unsigned long long hits = 0;
    for (int u0 = 0; u0 < units; u0 += 32) {
        const int u = u0 + lane;
        unsigned h = 0;
        if (u < units) {
            const int p = pos[w][u >> 3], ti = u & 7, i = p >> 3, j = p & 7;
            const float* a = &stage[w][0][i * S];
            const float* bb = &stage[w][1][j * S];
            const float amin0 = a[0 * 8 + ti], amin1 = a[1 * 8 + ti],
                        amin2 = a[2 * 8 + ti], amax0 = a[3 * 8 + ti],
                        amax1 = a[4 * 8 + ti], amax2 = a[5 * 8 + ti];
            const int ra = ra0 + i * 8 + ti, rb = rb0 + j * 8;
            float sa = 0.f, pa = 0.f;
            unsigned ma = 0;
            if (PARTS) {
                sa = a[6 * 8 + ti];
                pa = a[7 * 8 + ti];
                ma = __float_as_uint(a[8 * 8 + ti]);
            }
#pragma unroll
            for (int tj = 0; tj < 8; ++tj) {
                unsigned ok = (ra < rb + tj)
                    & (bb[0 * 8 + tj] <= amax0) & (bb[3 * 8 + tj] >= amin0)
                    & (bb[1 * 8 + tj] <= amax1) & (bb[4 * 8 + tj] >= amin1)
                    & (bb[2 * 8 + tj] <= amax2) & (bb[5 * 8 + tj] >= amin2);
                if (PARTS) {
                    const float sb = bb[6 * 8 + tj], pb = bb[7 * 8 + tj];
                    const unsigned mask_b = __float_as_uint(bb[8 * 8 + tj]);
                    ok &= !((sa == sb) | (pa == sb) | (pb == sa)
                            | ((ma & mask_b) != 0));
                }
                h |= ok;
            }
        }
        // Lanes 8g..8g+7 hold the units of the round's pair g.
        const unsigned votes = __ballot_sync(FULL, h != 0);
#pragma unroll
        for (int g = 0; g < 4; ++g)
            if ((votes >> (8 * g)) & 0xffu)
                hits |= 1ull << pos[w][(u0 >> 3) + g];
    }
    out[lane] = (uint8_t)((hits >> lane) & 1);
    out[32 + lane] = (uint8_t)((hits >> (32 + lane)) & 1);
}

}  // namespace

// tab [B, ns, 8 * Cb * 8] f32 (16-byte aligned), si, sj [B, Phs] int64,
// mb [B, Phs, 64] and hit [B, Phs, 64] bytes (bool), all contiguous;
// with_parts: Cb = 8, else 6; ign: n_ign (p, q) pairs as 2 * n_ign floats
// on the host, n_ign <= 16.  One launch.
extern "C" int level2_hits_forward(const float* tab, const long long* si,
                                   const long long* sj, const uint8_t* mb,
                                   uint8_t* hit, int B, int ns, int Phs,
                                   int with_parts, int n_ign,
                                   const float* ign_pq, void* stream) {
    if (B <= 0 || Phs <= 0) return 0;
    if (n_ign < 0 || n_ign > MAX_IGN || ns <= 0 || ns > (1 << 24))
        return (int)cudaErrorInvalidValue;
    IgnPairs ign{};
    ign.n = n_ign;
    for (int x = 0; x < n_ign; ++x) {
        ign.p[x] = ign_pq[2 * x];
        ign.q[x] = ign_pq[2 * x + 1];
    }
    const long long rows = (long long)B * Phs;
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (with_parts)
        k4_level2_hits<true><<<(int)blocks, THREADS, 0, s>>>(
            tab, si, sj, mb, hit, rows, Phs, ns, ign);
    else
        k4_level2_hits<false><<<(int)blocks, THREADS, 0, s>>>(
            tab, si, sj, mb, hit, rows, Phs, ns, ign);
    return (int)cudaGetLastError();
}
