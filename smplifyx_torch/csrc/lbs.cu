// Fused linear-blend skinning for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the TPU kernel smplifyx_tpu/ops/lbs_pallas.py::_kernel.
// Computes, for every lane b and vertex v,
//     T = sum_j W[v, j] * A[b, j, 0:12]          (the 3x4 part of the 4x4)
//     out[b, v] = T[0:3, 0:3] . v_posed[b, v] + T[0:3, 3]
// without writing the [B, V, 16] transform tensor to device memory.
//
// Bound on an H100 SXM at the main path's full-mesh shape (B=128, V=10475,
// J=55): 2*B*V*J*12 = 1.77 GFLOP of FP32 FMAs (about 26 us at 67 TFLOP/s)
// against ~34 MB of traffic (about 10 us at 3.35 TB/s), so the FP32 pipes
// bound it.  The design keeps those pipes fed from shared memory:
//   * one thread per vertex of a TILE-vertex tile; the tile of W^T
//     [J, TILE] sits in shared memory (padded to TILE+1 so the transposing
//     store is free of bank conflicts) and is read once per lane chunk;
//   * the 12 used columns of each lane's A[b] are staged in shared memory
//     and read as float4 broadcasts;
//   * each thread carries LANES lanes' 12 sums at once, so one W load
//     feeds 12*LANES FMAs.
// FP32 FMAs only: TF32 tensor cores would break f32 parity with the
// reference.  The ragged V edge and the ragged lane chunk are masked.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;          // vertices per block (= threads)
constexpr int LANES = 4;           // lanes accumulated together per thread
constexpr int LANES_PER_BLOCK = 8; // lanes one block walks through
constexpr int MAX_J = 64;          // shared memory is sized for J <= 64

__host__ __device__ inline int wt_floats(int J) {
    // W^T tile, rounded up to 4 floats so the A stage stays 16-byte aligned.
    return ((J * (TILE + 1)) + 3) & ~3;
}

__global__ void __launch_bounds__(TILE)
lbs_kernel(const float* __restrict__ W, const float* __restrict__ A,
           const float* __restrict__ v, float* __restrict__ out,
           int B, int V, int J) {
    extern __shared__ __align__(16) float smem[];
    float* wt = smem;                    // [J][TILE + 1]
    float* as = smem + wt_floats(J);     // [LANES][J][12]

    const int t = threadIdx.x;
    const int v0 = blockIdx.x * TILE;
    const int vi = v0 + t;

    // W rows v0..v0+TILE are contiguous in memory: read them coalesced and
    // store transposed.
    for (int idx = t; idx < TILE * J; idx += TILE) {
        const int r = idx / J;
        const int j = idx - r * J;
        const int vv = v0 + r;
        wt[j * (TILE + 1) + r] = (vv < V) ? W[(size_t)vv * J + j] : 0.0f;
    }

    const int b_begin = blockIdx.y * LANES_PER_BLOCK;
    const int b_end = min(B, b_begin + LANES_PER_BLOCK);
    for (int b0 = b_begin; b0 < b_end; b0 += LANES) {
        const int nl = min(LANES, b_end - b0);
        __syncthreads();  // W^T stored; the previous chunk's A reads done
        for (int idx = t; idx < LANES * J * 12; idx += TILE) {
            const int l = idx / (J * 12);
            const int rem = idx - l * (J * 12);
            const int j = rem / 12;
            const int k = rem - j * 12;
            as[idx] = (l < nl) ? A[((size_t)(b0 + l) * J + j) * 16 + k] : 0.0f;
        }
        __syncthreads();
        if (vi < V) {
            float acc[LANES][12];
#pragma unroll
            for (int l = 0; l < LANES; ++l)
#pragma unroll
                for (int k = 0; k < 12; ++k) acc[l][k] = 0.0f;
            for (int j = 0; j < J; ++j) {
                const float w = wt[j * (TILE + 1) + t];
#pragma unroll
                for (int l = 0; l < LANES; ++l) {
                    const float4* a =
                        reinterpret_cast<const float4*>(as + (l * J + j) * 12);
                    const float4 a0 = a[0], a1 = a[1], a2 = a[2];
                    acc[l][0] = fmaf(w, a0.x, acc[l][0]);
                    acc[l][1] = fmaf(w, a0.y, acc[l][1]);
                    acc[l][2] = fmaf(w, a0.z, acc[l][2]);
                    acc[l][3] = fmaf(w, a0.w, acc[l][3]);
                    acc[l][4] = fmaf(w, a1.x, acc[l][4]);
                    acc[l][5] = fmaf(w, a1.y, acc[l][5]);
                    acc[l][6] = fmaf(w, a1.z, acc[l][6]);
                    acc[l][7] = fmaf(w, a1.w, acc[l][7]);
                    acc[l][8] = fmaf(w, a2.x, acc[l][8]);
                    acc[l][9] = fmaf(w, a2.y, acc[l][9]);
                    acc[l][10] = fmaf(w, a2.z, acc[l][10]);
                    acc[l][11] = fmaf(w, a2.w, acc[l][11]);
                }
            }
#pragma unroll
            for (int l = 0; l < LANES; ++l) {
                if (l < nl) {
                    const size_t o = ((size_t)(b0 + l) * V + vi) * 3;
                    const float x = v[o], y = v[o + 1], z = v[o + 2];
                    const float* T = acc[l];
                    out[o] = T[0] * x + T[1] * y + T[2] * z + T[3];
                    out[o + 1] = T[4] * x + T[5] * y + T[6] * z + T[7];
                    out[o + 2] = T[8] * x + T[9] * y + T[10] * z + T[11];
                }
            }
        }
    }
}

}  // namespace

// W [V, J], A [B, J, 16], v [B, V, 3], out [B, V, 3]; all f32, contiguous,
// on the current device.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); the caller raises on anything else.
extern "C" int lbs_forward(const float* W, const float* A, const float* v,
                           float* out, int B, int V, int J, void* stream) {
    if (B <= 0 || V <= 0) return 0;
    if (J <= 0 || J > MAX_J) return (int)cudaErrorInvalidValue;
    const dim3 grid((V + TILE - 1) / TILE,
                    (B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK);
    const size_t shmem = (size_t)(wt_floats(J) + LANES * J * 12) * sizeof(float);
    lbs_kernel<<<grid, TILE, shmem, (cudaStream_t)stream>>>(W, A, v, out, B, V, J);
    return (int)cudaGetLastError();
}
