// Linear-blend skinning for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the TPU kernel smplifyx_tpu/ops/lbs_pallas.py::_kernel.
// Computes, for every lane b and vertex v,
//     T = sum over the plan's row v of W[v, j] * A[b, j, 0:12]
//     out[b, v] = T[0:3, 0:3] . v_posed[b, v] + T[0:3, 3]
// without writing the [B, V, 16] transform tensor to device memory.  W
// comes as its column plan (smplifyx_torch/ops/lbs.py::lbs_plan): per
// vertex the K columns of its nonzero weights in ascending order and their
// values, padded with columns of weight zero.
//
// Bound, for an NVIDIA H100 80GB HBM3 at a 700 W power limit (3.35 TB/s,
// 67 TFLOP/s FP32), at the full-mesh shape B=256, V=10475, J=55 with the
// synthetic models' 4 weights per vertex (nnz = 41,900): v_posed read and
// out written once (64.4 MB), A (0.9 MB) and 8 bytes per nonzero (0.34 MB)
// take 0.0196 ms; the 0.31 GFLOP take 0.005 ms.  So bytes bound it, and
// the 93% of W's entries that are zero cost nothing.  Inside the SM every
// output reads 48 floats of A (K=4 joints x 12) from shared memory, so the
// reads of A must not conflict on banks.  The design:
//   * grid = vertex chunks x lane groups, in one wave.  The launcher picks
//     the lanes of a block so that one tile per block would give at least
//     two blocks per SM where the shape allows, then cuts the vertices into
//     as many chunks as the SMs hold such blocks at once (the landmark
//     subset B=256, V=224: 4 lanes, one 32-vertex tile per block, 448
//     blocks; the full mesh at B=256: 8 lanes, 16 chunks of 655 vertices,
//     512 blocks, 4 on an SM).  A block stages A once and walks its chunk
//     in tiles of up to 128 vertices through STAGES buffers: the next
//     tile's rows and plan load while this one is summed and stored;
//   * a block of 32 x lanes threads; consecutive threads carry the block's
//     lanes of one vertex, so the 8 threads of a quarter-warp read the same
//     joints of 8 lanes.  A lane's slab of A has an odd number of 16-byte
//     words, so those 8 float4 reads fall on 8 different bank groups: no
//     bank conflict, whatever joints the vertex has;
//   * for K <= 4 the tile's span of the plan is staged with its rows; each
//     thread reads its vertex's K (col, val) pairs once, into registers (as
//     an int4 and a float4 when K is 4), and the quarter-warp's threads
//     read the same pairs, which shared memory broadcasts.  A wider plan
//     is read from device memory in the loop;
//   * the 12 used floats of each (lane, joint) of A are staged in shared
//     memory with 16-byte cp.async copies (faster at every main-path shape
//     than reading them through the read-only path);
//   * v_posed and out are [B, V, 3]: each lane's rows of the tile are one
//     contiguous span, copied into shared memory as the 16-byte chunks that
//     cover it and written back the same way (whole chunks as float4, the
//     two partial ends word by word), a warp per lane, so no 12-byte row
//     splits a transaction.  The result goes back into the same slots.
// The sum runs over the plan's row in order with fmaf, and the epilogue is
// the dense kernel's expression (lbs_reference's, in f32): a skipped zero
// weight would add fmaf(0, a, acc) == acc, so the output equals a dense
// loop over all J columns bit for bit.  That holds for finite A only: an
// Inf or NaN in A[b, j] at a joint j of weight zero makes the dense sum
// NaN, and this one does not see it.  FP32 only: TF32 tensor cores would
// break f32 parity with the reference.
//
// Shared memory is the only limit on J: lanes x (12 J + 4) floats of A
// plus STAGES buffers of lanes x (3 x tile + 4) floats of rows and, for
// K <= 4, 2 x (tile x 4 + 4) of plan must fit what a block may opt into
// (227 KB on an H100: J <= 4,781 at one lane of 32 vertices, which
// lbs_max_joints reports).  The launcher halves lanes, then the tile,
// until the block fits.  It works out a shape's launch once per device
// and keeps it: later calls of that shape only launch.
//
// Built with -DLBS_NO_SUM the kernel stages A, the plan and the rows and
// stores the rows back unchanged: its memory path alone, which
// smplifyx_torch/tools/lbs_limits.py times beside the kernel.

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int MIN_TILE = 32;
constexpr int MAX_TILE = 128;
constexpr int MAX_LANES = 8;
constexpr int MAX_GRID_Y = 65535;
constexpr int BLOCKS_PER_SM = 2;
constexpr int STAGES = 2;

__host__ __device__ inline int row_floats(int tile) { return 3 * tile + 4; }

__device__ inline void cp_async16(float* smem, const float* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ inline void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ inline void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Floats of one lane's slab of A: 12 per joint, rounded to an odd number
// of float4 words.
__host__ __device__ inline int a_stride(int J) {
    return 4 * (3 * J + ((3 * J) % 2 == 0));
}

// Floats of the plan's staged span per buffer (cols or vals): K <= KR
// entries for each of `tile` vertices, plus the span's offset.
__host__ __device__ inline int plan_floats(int tile, int KR) {
    return KR > 0 ? tile * KR + 4 : 0;
}

// One 16-byte chunk of src (total words) at word g into dst: cp.async,
// or word by word at the end of src.
__device__ inline void copy_chunk(float* dst, const float* src, long long g,
                                  long long total) {
    if (g + 4 <= total) {
        cp_async16(dst, src + g);
    } else {
        for (int e = 0; g + e < total; ++e) dst[e] = src[g + e];
    }
}

// The rows of vertices v0 .. v0+nv of every lane into `rows` (lane l's are
// the words [s, s + 3 nv) of v, as the 16-byte chunks that cover them: word
// s lands at rows[l][s & 3]) and, for KR > 0, the plan's cols and vals of
// those vertices after them.  A block has 32 x lanes threads: warp l
// copies lane l's rows.
template <int KR>
__device__ inline void stage_tile(float* rows, int rf, int pf, const float* v,
                                  const int* cols, const float* vals, int B,
                                  int V, int K, int b0, int nl, int v0,
                                  int nv, int lanes) {
    const long long total = (long long)B * V * 3;
    for (int l = threadIdx.x / 32; l < nl; l += blockDim.x / 32) {
        const long long s = ((long long)(b0 + l) * V + v0) * 3;
        const long long c0 = s >> 2;
        const int chunks = (int)(((s + 3 * nv + 3) >> 2) - c0);
        for (int c = threadIdx.x % 32; c < chunks; c += 32)
            copy_chunk(rows + l * rf + 4 * c, v, (c0 + c) * 4, total);
    }
    if constexpr (KR > 0) {
        float* plan = rows + lanes * rf;
        const long long s = (long long)v0 * K, total_k = (long long)V * K;
        const int chunks = (int)(((s + nv * K + 3) >> 2) - (s >> 2));
        for (int i = threadIdx.x; i < 2 * chunks; i += blockDim.x) {
            const int half = i >= chunks, c = i - half * chunks;
            copy_chunk(plan + half * pf + 4 * c,
                       half ? vals : reinterpret_cast<const float*>(cols),
                       ((s >> 2) + c) * 4, total_k);
        }
    }
}

// Whole chunks inside each lane's span as float4; the partial ends (shared
// with the neighbouring tile or lane) word by word.  A warp per lane.
__device__ inline void store_tile(const float* rows, int rf, float* out,
                                  int b0, int nl, int V, int v0, int nv) {
    for (int l = threadIdx.x / 32; l < nl; l += blockDim.x / 32) {
        const long long s = ((long long)(b0 + l) * V + v0) * 3;
        const long long e = s + 3 * nv;
        const long long c0 = s >> 2;
        const int chunks = (int)(((e + 3) >> 2) - c0);
        for (int c = threadIdx.x % 32; c < chunks; c += 32) {
            const long long g = (c0 + c) * 4;
            const float* src = rows + l * rf + 4 * c;
            if (g >= s && g + 4 <= e) {
                *reinterpret_cast<float4*>(out + g) =
                    *reinterpret_cast<const float4*>(src);
            } else {
                for (int q = 0; q < 4; ++q)
                    if (g + q >= s && g + q < e) out[g + q] = src[q];
            }
        }
    }
}

// KR == 4: the plan staged with the rows, each row in registers (K <= 4);
// KR == 0: read from device memory in the loop.  A block of 32 x lanes
// threads covers the vertices [blockIdx.x * chunk, + chunk) of `lanes`
// lanes, `tile` vertices at a time, through a ring of STAGES buffers: the
// rows and plan of the next STAGES - 1 tiles load while one is summed and
// stored.
template <int KR>
__global__ void lbs_kernel(const int* __restrict__ cols,
                           const float* __restrict__ vals,
                           const float* __restrict__ A,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           int B, int V, int J, int K, int tile, int chunk,
                           int lanes) {
    extern __shared__ __align__(16) float smem[];
    const int t = threadIdx.x;
    const int vbeg = blockIdx.x * chunk;
    const int vend = min(V, vbeg + chunk);
    const int b0 = blockIdx.y * lanes;
    const int nl = min(lanes, B - b0);
    const int as_stride = a_stride(J);
    float* as = smem;                                   // [lanes][a_stride]
    const int rf = row_floats(tile);
    const int pf = plan_floats(tile, KR);
    const int buf_floats = lanes * rf + 2 * pf;    // rows [lanes][rf], plan
    float* bufs = smem + lanes * as_stride;        // STAGES of them

    for (int i = t; i < nl * J * 3; i += blockDim.x) {
        const int lj = i / 3;                           // l * J + j
        const int q = i - 3 * lj;
        const int l = lj / J;
        cp_async16(as + l * as_stride + (lj - l * J) * 12 + 4 * q,
                   A + ((long long)b0 * J + lj) * 16 + 4 * q);
    }
    // One commit group per tile, empty past the chunk's end, so that tile
    // i's group is complete when at most STAGES - 2 later ones are not.
    for (int k = 0; k < STAGES - 1; ++k) {
        const int vk = vbeg + k * tile;
        if (vk < vend)
            stage_tile<KR>(bufs + k * buf_floats, rf, pf, v, cols, vals, B, V,
                           K, b0, nl, vk, min(tile, vend - vk), lanes);
        cp_async_commit();
    }

    const int l = t % lanes;
    const float* al = as + l * as_stride;
    for (int v0 = vbeg, i = 0; v0 < vend; v0 += tile, ++i) {
        const int nv = min(tile, vend - v0);
        float* cur = bufs + (i % STAGES) * buf_floats;
        cp_async_wait<STAGES - 2>();
        __syncthreads();        // tile i landed; tile i - 1 is stored
        const int vn = v0 + (STAGES - 1) * tile;
        if (vn < vend)
            stage_tile<KR>(bufs + ((i + STAGES - 1) % STAGES) * buf_floats, rf,
                           pf, v, cols, vals, B, V, K, b0, nl, vn,
                           min(tile, vend - vn), lanes);
        cp_async_commit();

#ifndef LBS_NO_SUM
        if (l < nl) {
            const long long s = ((long long)(b0 + l) * V + v0) * 3;
            float* row = cur + l * rf + (int)(s & 3);
            const int* plan_c = cols + (long long)v0 * K;
            const float* plan_w = vals + (long long)v0 * K;
            if constexpr (KR > 0) {
                plan_w = cur + lanes * rf + (int)(((long long)v0 * K) & 3);
                plan_c = reinterpret_cast<const int*>(plan_w);
                plan_w += pf;
            }
            for (int vi = t / lanes; vi < nv; vi += 32) {
                const int* pc = plan_c + vi * K;
                const float* pw = plan_w + vi * K;
                float T[12];
#pragma unroll
                for (int k = 0; k < 12; ++k) T[k] = 0.0f;
                auto add = [&](int j, float w) {
                    const float4* a =
                        reinterpret_cast<const float4*>(al + j * 12);
                    const float4 a0 = a[0], a1 = a[1], a2 = a[2];
                    T[0] = fmaf(w, a0.x, T[0]);
                    T[1] = fmaf(w, a0.y, T[1]);
                    T[2] = fmaf(w, a0.z, T[2]);
                    T[3] = fmaf(w, a0.w, T[3]);
                    T[4] = fmaf(w, a1.x, T[4]);
                    T[5] = fmaf(w, a1.y, T[5]);
                    T[6] = fmaf(w, a1.z, T[6]);
                    T[7] = fmaf(w, a1.w, T[7]);
                    T[8] = fmaf(w, a2.x, T[8]);
                    T[9] = fmaf(w, a2.y, T[9]);
                    T[10] = fmaf(w, a2.z, T[10]);
                    T[11] = fmaf(w, a2.w, T[11]);
                };
                if constexpr (KR > 0) {
                    int cj[KR];
                    float cw[KR];
                    if (K == KR) {      // rows 16-byte aligned: vectors
#pragma unroll
                        for (int k = 0; k < KR; k += 4) {
                            const int4 c4 =
                                *reinterpret_cast<const int4*>(pc + k);
                            const float4 w4 =
                                *reinterpret_cast<const float4*>(pw + k);
                            cj[k] = c4.x; cj[k + 1] = c4.y;
                            cj[k + 2] = c4.z; cj[k + 3] = c4.w;
                            cw[k] = w4.x; cw[k + 1] = w4.y;
                            cw[k + 2] = w4.z; cw[k + 3] = w4.w;
                        }
                    } else {
#pragma unroll
                        for (int k = 0; k < KR; ++k) {
                            cj[k] = k < K ? pc[k] : 0;
                            cw[k] = k < K ? pw[k] : 0.0f;
                        }
                    }
#pragma unroll
                    for (int k = 0; k < KR; ++k)
                        if (k < K) add(cj[k], cw[k]);
                } else {
                    for (int k = 0; k < K; ++k) add(pc[k], pw[k]);
                }
                float* p = row + 3 * vi;
                const float x = p[0], y = p[1], z = p[2];
                p[0] = T[0] * x + T[1] * y + T[2] * z + T[3];
                p[1] = T[4] * x + T[5] * y + T[6] * z + T[7];
                p[2] = T[8] * x + T[9] * y + T[10] * z + T[11];
            }
        }
#endif
        __syncthreads();
        store_tile(cur, rf, out, b0, nl, V, v0, nv);
    }
}

size_t shmem_bytes(int tile, int lanes, int J, int KR) {
    return sizeof(float) * ((size_t)lanes * a_stride(J)
                            + STAGES * ((size_t)lanes * row_floats(tile)
                                        + 2 * plan_floats(tile, KR)));
}

int device_attribute(cudaDeviceAttr attr, int dev) {
    int value = 0;
    cudaDeviceGetAttribute(&value, attr, dev);
    return value;
}

// The launch of one shape on one device.
struct Config {
    int dev, B, V, J, K;        // the shape
    int kr, tile, lanes, chunk;
    size_t shmem;
    dim3 grid;
};

std::mutex config_mutex;
std::vector<Config> configs;
// The dynamic shared memory each (device, KR) kernel was opened to: it only
// grows, so every kept launch stays valid.
std::map<std::pair<int, int>, size_t> opened;

// Open the kernel to `shmem` bytes on `dev` and count how many of its
// blocks an SM holds.
template <int KR>
cudaError_t resident_blocks(int dev, int lanes, size_t shmem, int* per_sm) {
    auto kernel = lbs_kernel<KR>;
    size_t& bytes = opened[{dev, KR}];
    if (shmem > 48 * 1024 && shmem > bytes) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (err != cudaSuccess) return err;
        bytes = shmem;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         32 * lanes, shmem);
}

// Tile and lanes so that one tile per block gives BLOCKS_PER_SM blocks per
// SM where the shape allows and the block fits shared memory; then one
// wave: as many vertex chunks per lane group as the SMs hold blocks of
// this size, at most one per tile.
cudaError_t make_config(int dev, int B, int V, int J, int K, Config* c) {
    const int sms = device_attribute(cudaDevAttrMultiProcessorCount, dev);
    const size_t room = (size_t)device_attribute(
        cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const int kr = K <= 4 ? 4 : 0;
    int tile = MAX_TILE;
    while (tile > MIN_TILE && tile * 32 > V) tile /= 2;
    const int tiles = (V + tile - 1) / tile;
    int lanes = MAX_LANES;
    while (lanes > 1
           && (long long)tiles * ((B + lanes - 1) / lanes) < BLOCKS_PER_SM * sms)
        lanes /= 2;
    while (shmem_bytes(tile, lanes, J, kr) > room) {
        if (lanes > 1) lanes /= 2;
        else if (tile > MIN_TILE) tile /= 2;
        else return cudaErrorInvalidValue;
    }
    const int groups = (B + lanes - 1) / lanes;
    if (groups > MAX_GRID_Y) return cudaErrorInvalidValue;
    const size_t shmem = shmem_bytes(tile, lanes, J, kr);
    int per_sm = 0;
    const cudaError_t err =
        kr == 4 ? resident_blocks<4>(dev, lanes, shmem, &per_sm)
                : resident_blocks<0>(dev, lanes, shmem, &per_sm);
    if (err != cudaSuccess) return err;
    const int chunks = (int)std::max(1LL, std::min<long long>(
        tiles, (long long)per_sm * sms / groups));
    const int chunk = (V + chunks - 1) / chunks;
    *c = Config{dev, B, V, J, K, kr, tile, lanes, chunk, shmem,
                dim3((V + chunk - 1) / chunk, groups)};
    return cudaSuccess;
}

}  // namespace

// The widest J the kernel takes whatever K: one lane, two buffers of the
// smallest tile with the widest staged plan, A staged.
extern "C" int lbs_max_joints() {
    int dev = 0;
    cudaGetDevice(&dev);
    const long long room =
        (long long)device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev) / (long long)sizeof(float)
        - STAGES * (row_floats(MIN_TILE) + 2 * plan_floats(MIN_TILE, 4));
    return (int)((room - 4) / 12);
}

// cols [V, K] int32, vals [V, K], A [B, J, 16], v [B, V, 3], out [B, V, 3];
// f32, contiguous, all 16-byte aligned, on the current device.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int lbs_forward(const int* cols, const float* vals, const float* A,
                           const float* v, float* out, int B, int V, int J,
                           int K, void* stream) {
    if (B <= 0 || V <= 0) return 0;
    if (J <= 0 || K <= 0 || K > J) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    Config c;
    {
        std::lock_guard<std::mutex> lock(config_mutex);
        auto it = std::find_if(configs.begin(), configs.end(),
                               [&](const Config& k) {
            return k.dev == dev && k.B == B && k.V == V && k.J == J && k.K == K;
        });
        if (it != configs.end()) {
            c = *it;
        } else {
            err = make_config(dev, B, V, J, K, &c);
            if (err != cudaSuccess) return (int)err;
            configs.push_back(c);
        }
    }
    const dim3 block(32 * c.lanes);
    const cudaStream_t s = (cudaStream_t)stream;
    if (c.kr == 4)
        lbs_kernel<4><<<c.grid, block, c.shmem, s>>>(
            cols, vals, A, v, out, B, V, J, K, c.tile, c.chunk, c.lanes);
    else
        lbs_kernel<0><<<c.grid, block, c.shmem, s>>>(
            cols, vals, A, v, out, B, V, J, K, c.tile, c.chunk, c.lanes);
    return (int)cudaGetLastError();
}
