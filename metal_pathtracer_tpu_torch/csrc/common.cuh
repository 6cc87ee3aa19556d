// Shared device helpers for the port's CUDA kernels.
//
// Every helper mirrors its PyTorch twin in ops/vecmath.py operation for
// operation, so a kernel and its plain version produce the same bits:
//  - the build passes --fmad=false, so nvcc fuses nothing by itself;
//  - FMAs appear only where the reference's XLA:CPU build contracts
//    (__fmaf_rn here, vecmath.fma there): 3-term dots, cross products,
//    2-term sums of products;
//  - min/max/clamp propagate NaN like torch.minimum/maximum/clamp;
//  - division and sqrtf are IEEE-rounded (no fast math).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct V3 {
  float x, y, z;
};

__host__ __device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r = {x, y, z};
  return r;
}
__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, long long i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// torch.maximum / torch.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float minn(float a, float b) {
  return (a != a || a < b) ? a : b;
}
// torch.clamp_min / clamp_max / clamp with a constant bound
__device__ __forceinline__ float cmin(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float cmax(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return cmax(cmin(x, lo), hi);
}
__device__ __forceinline__ V3 cmin3(V3 a, float lo) {
  return v3(cmin(a.x, lo), cmin(a.y, lo), cmin(a.z, lo));
}
__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}

__device__ __forceinline__ float fmaf_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
// fma(a, b, c) per component with a scalar a (vecmath.fma broadcast)
__device__ __forceinline__ V3 fma3(float a, V3 b, V3 c) {
  return v3(fmaf_rn(a, b.x, c.x), fmaf_rn(a, b.y, c.y), fmaf_rn(a, b.z, c.z));
}
__device__ __forceinline__ V3 fma3v(V3 a, float b, V3 c) {
  return v3(fmaf_rn(a.x, b, c.x), fmaf_rn(a.y, b, c.y), fmaf_rn(a.z, b, c.z));
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return fmaf_rn(a.z, b.z, fmaf_rn(a.y, b.y, a.x * b.x));
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(fmaf_rn(a.y, b.z, -(a.z * b.y)), fmaf_rn(a.z, b.x, -(a.x * b.z)),
            fmaf_rn(a.x, b.y, -(a.y * b.x)));
}
__device__ __forceinline__ V3 normalize3(V3 v) {
  return v / sqrtf(cmin(dot3(v, v), 1e-38f));
}
__device__ __forceinline__ V3 safe_normalize3(V3 v) {
  float len2 = dot3(v, v);
  float inv = len2 > 0.0f ? 1.0f / sqrtf(cmin(len2, 1e-38f)) : 0.0f;
  return v * inv;
}
// Rec.709 luminance, contracted like the reference
__device__ __forceinline__ float luminance3(V3 c) {
  return fmaf_rn(c.z, 0.0722f, fmaf_rn(c.y, 0.7152f, c.x * 0.2126f));
}

// PCG output hash (reference: pathtrace.metal:55-59) and its uniform
__device__ __forceinline__ uint32_t pcg_hash(uint32_t s) {
  s = s * 747796405u + 2891336453u;
  uint32_t word = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ float rand_uniform(uint32_t* s) {
  *s = pcg_hash(*s);
  return __uint2float_rn(*s) * 2.3283064365386963e-10f;  // 2^-32
}

// linear sRGB -> ACEScg (vecmath.linear_srgb_to_acescg)
__device__ inline V3 to_acescg(V3 c) {
  return v3(fmaf_rn(0.047380f, c.z, fmaf_rn(0.339523f, c.y, 0.613097f * c.x)),
            fmaf_rn(0.013452f, c.z, fmaf_rn(0.916354f, c.y, 0.070194f * c.x)),
            fmaf_rn(0.869816f, c.z, fmaf_rn(0.109569f, c.y, 0.020615f * c.x)));
}

// One triangle's shade_packed row, columns 0-19 (v0, v1, v2, n0, n1, n2,
// material, mesh), as five 16-byte loads of its 96-byte row (the table is
// 16-byte aligned: the wrappers check)
struct TriRow {
  float4 a, b, c, d, e;
};
__device__ __forceinline__ const float4* tri_row(const float* shade_packed,
                                                 int tri) {
  return reinterpret_cast<const float4*>(shade_packed) + 6LL * tri;
}
// the row's columns 16-19 alone (n2.yz, material, mesh)
__device__ __forceinline__ float4 tri_row_tail(const float* shade_packed,
                                               int tri) {
  return __ldg(tri_row(shade_packed, tri) + 4);
}
// the rest of a row whose tail is already loaded
__device__ __forceinline__ TriRow load_tri_row(const float* shade_packed,
                                               int tri, float4 tail) {
  const float4* r = tri_row(shade_packed, tri);
  TriRow row = {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3), tail};
  return row;
}
__device__ __forceinline__ V3 row_v0(const TriRow& r) {
  return v3(r.a.x, r.a.y, r.a.z);
}
__device__ __forceinline__ V3 row_v1(const TriRow& r) {
  return v3(r.a.w, r.b.x, r.b.y);
}
__device__ __forceinline__ V3 row_v2(const TriRow& r) {
  return v3(r.b.z, r.b.w, r.c.x);
}

// traversal._hit_record_from_best for one lane: the shade_packed row of
// the hit triangle gives the point, the faced geometric normal and the
// interpolated shading normal, as the hit record holds it (shading_rec)
// and with the integrator's bad-normal fallback (shading_n). is_tri and
// two_sided tell a triangle from an analytic primitive (shade.cu
// rebuild_analytic): only triangles take the self-hit exclusion ids, and
// spheres and some rectangles emit from both sides.
struct Hit {
  V3 point, n_faced, shading_rec, shading_n;
  bool front, is_tri, two_sided;
  int material, mesh;
};
__device__ inline Hit rebuild_hit_row(const TriRow& row, V3 ray_o, V3 ray_d,
                                      float t, float u, float v) {
  V3 v0 = row_v0(row), v1 = row_v1(row), v2 = row_v2(row);
  V3 n0 = v3(row.c.y, row.c.z, row.c.w);
  V3 n1 = v3(row.d.x, row.d.y, row.d.z);
  V3 n2 = v3(row.d.w, row.e.x, row.e.y);
  Hit h;
  h.is_tri = true;
  h.two_sided = false;
  h.material = (int)row.e.z;
  h.mesh = (int)row.e.w;
  h.point = fma3(t, ray_d, ray_o);
  V3 geo_n = safe_normalize3(cross3(v1 - v0, v2 - v0));
  h.front = dot3(ray_d, geo_n) < 0.0f;
  h.n_faced = sel(h.front, geo_n, -geo_n);
  // interpolate_shading_normal
  float w0 = cmin((1.0f - u) - v, 0.0f), w1 = cmin(u, 0.0f),
        w2 = cmin(v, 0.0f);
  float w_sum = (w0 + w1) + w2;
  bool has_w = w_sum > 1e-8f;
  w0 = has_w ? w0 / w_sum : 1.0f;
  w1 = has_w ? w1 / w_sum : 0.0f;
  w2 = has_w ? w2 / w_sum : 0.0f;
  V3 sn = v3(fmaf_rn(w2, n2.x, fmaf_rn(w0, n0.x, w1 * n1.x)),
             fmaf_rn(w2, n2.y, fmaf_rn(w0, n0.y, w1 * n1.y)),
             fmaf_rn(w2, n2.z, fmaf_rn(w0, n0.z, w1 * n1.z)));
  bool sn_ok = finite3(sn) && dot3(sn, sn) > 0.0f;
  sn = dot3(sn, h.n_faced) < 0.0f ? -sn : sn;
  sn = safe_normalize3(sn);
  h.shading_rec = sel(sn_ok, sn, h.n_faced);
  h.shading_n = h.shading_rec;
  if (!finite3(h.shading_n) || dot3(h.shading_n, h.shading_n) <= 0.0f)
    h.shading_n = h.n_faced;
  return h;
}
__device__ __forceinline__ Hit rebuild_hit(const float* shade_packed, int tri,
                                           V3 ray_o, V3 ray_d, float t,
                                           float u, float v) {
  return rebuild_hit_row(
      load_tri_row(shade_packed, tri, tri_row_tail(shade_packed, tri)),
      ray_o, ray_d, t, u, v);
}

// The port-internal family code of flat placement 0 of the instanced
// groups (ops/intersect.py KIND_INSTANCE): a lane's family KIND_INSTANCE + k
// names row k of the instance table (schema.InstanceTable, 32 floats:
// world -> local rows, normal matrix at 12-20, then as int bits the
// material at 21, the object-triangle offset at 26, the global instance id
// at 27).
#define KIND_INSTANCE 4

// x @ nrm.T with the 3x3 matrix at m (row-major): a 3-term dot per row
__device__ __forceinline__ V3 mat3_rows(const float* m, V3 x) {
  return v3(dot3(x, v3(m[0], m[1], m[2])), dot3(x, v3(m[3], m[4], m[5])),
            dot3(x, v3(m[6], m[7], m[8])));
}

// traversal.instanced_record for one lane (ops/traversal.py _trace_group's
// arithmetic): the object-space shade_packed row of the placement's group
// (inst_shade: the groups' rows one after the other) gives the world-space
// point, the geometric normal cross(v1 - v0, v2 - v0) mapped by the normal
// matrix, normalised and faced, and the shading normal interpolated with
// the clamped weights over their sum, mapped, flipped to the faced normal
// and finite-checked; the placement's material, its global instance id as
// the mesh.
__device__ inline Hit rebuild_instanced(const float* table,
                                        const float* inst_shade, int k,
                                        int tri, V3 ray_o, V3 ray_d, float t,
                                        float u, float v) {
  const float* row_k = table + 32LL * k;
  const float* nrm = row_k + 12;
  TriRow row = load_tri_row(
      inst_shade, __float_as_int(__ldg(row_k + 26)) + tri,
      tri_row_tail(inst_shade, __float_as_int(__ldg(row_k + 26)) + tri));
  V3 v0 = row_v0(row), v1 = row_v1(row), v2 = row_v2(row);
  V3 n0 = v3(row.c.y, row.c.z, row.c.w);
  V3 n1 = v3(row.d.x, row.d.y, row.d.z);
  V3 n2 = v3(row.d.w, row.e.x, row.e.y);
  Hit h;
  h.is_tri = true;
  h.two_sided = false;
  h.material = __float_as_int(__ldg(row_k + 21));
  h.mesh = __float_as_int(__ldg(row_k + 27));
  h.point = fma3(t, ray_d, ray_o);
  V3 geo_w = safe_normalize3(mat3_rows(nrm, cross3(v1 - v0, v2 - v0)));
  h.front = dot3(ray_d, geo_w) < 0.0f;
  h.n_faced = sel(h.front, geo_w, -geo_w);
  float w0 = cmin((1.0f - u) - v, 0.0f), w1 = cmin(u, 0.0f),
        w2 = cmin(v, 0.0f);
  float w_sum = cmin((w0 + w1) + w2, 1e-8f);
  V3 sn_l = v3(fmaf_rn(w2, n2.x, fmaf_rn(w0, n0.x, w1 * n1.x)) / w_sum,
               fmaf_rn(w2, n2.y, fmaf_rn(w0, n0.y, w1 * n1.y)) / w_sum,
               fmaf_rn(w2, n2.z, fmaf_rn(w0, n0.z, w1 * n1.z)) / w_sum);
  V3 sn = mat3_rows(nrm, sn_l);
  bool sn_ok = finite3(sn) && dot3(sn, sn) > 0.0f;
  sn = dot3(sn, h.n_faced) < 0.0f ? -sn : sn;
  h.shading_rec = sel(sn_ok, safe_normalize3(sn), h.n_faced);
  h.shading_n = h.shading_rec;
  if (!finite3(h.shading_n) || dot3(h.shading_n, h.shading_n) <= 0.0f)
    h.shading_n = h.n_faced;
  return h;
}

// value k of lane i in a plane-major (k, n) float32 array
__device__ __forceinline__ float plane_at(const float* p, int n,
                                          long long i, int k) {
  return p[(long long)k * n + i];
}

// ---- live-lane lists (K1's walks, K2 s2 and full, K3b) --------------------
// Appends lane i to list[0..*count) when `live`: each warp's ballot, a
// block-local scan of the warps' counts and one atomic per block, so the
// listed lanes of a block stay in ascending order. Every thread of the block
// calls it (it holds two __syncthreads); BLOCK_THREADS is the block size, a
// multiple of 32 up to 1024.
template <int BLOCK_THREADS>
__device__ __forceinline__ void list_append(bool live, int i, int* count,
                                            int* list) {
  constexpr int kWarps = BLOCK_THREADS / 32;
  __shared__ int warp_base[kWarps];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned mask = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_base[warp] = __popc(mask);
  __syncthreads();
  if (warp == 0) {
    int own = lane < kWarps ? warp_base[lane] : 0;
    int incl = own;
    for (int off = 1; off < 32; off <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = 0;
    if (lane == 0 && total > 0) base = atomicAdd(count, total);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (lane < kWarps) warp_base[lane] = base + incl - own;
  }
  __syncthreads();
  if (live) list[warp_base[warp] + __popc(mask & ((1u << lane) - 1u))] = i;
}

// list_append over KEYS lists at once: lane i goes to list `key` (none when
// key < 0), at lists[key * stride + position]. One ballot per key a warp,
// the warps' counts scanned per key by one warp each and one atomic per
// block and key present, so each list's lanes of a block stay in ascending
// order. Every thread of the block calls it (two __syncthreads).
template <int BLOCK_THREADS, int KEYS>
__device__ __forceinline__ void list_append_keyed(int key, int i, int* counts,
                                                  int* lists, int stride) {
  constexpr int kWarps = BLOCK_THREADS / 32;
  static_assert(KEYS <= kWarps, "one warp scans each key");
  __shared__ int warp_base[KEYS][kWarps];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned mine = 0;
#pragma unroll
  for (int k = 0; k < KEYS; ++k) {
    unsigned mask = __ballot_sync(0xffffffffu, key == k);
    if (key == k) mine = mask;
    if (lane == 0) warp_base[k][warp] = __popc(mask);
  }
  __syncthreads();
  if (warp < KEYS) {
    int own = lane < kWarps ? warp_base[warp][lane] : 0;
    int incl = own;
    for (int off = 1; off < 32; off <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = 0;
    if (lane == 0 && total > 0) base = atomicAdd(counts + warp, total);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (lane < kWarps) warp_base[warp][lane] = base + incl - own;
  }
  __syncthreads();
  if (key >= 0)
    lists[(long long)key * stride + warp_base[key][warp] +
          __popc(mine & ((1u << lane) - 1u))] = i;
}

// the first list position of this warp's next batch of 32 (the same on
// every lane; every lane of the warp calls it)
__device__ __forceinline__ int next_batch(int* fetch) {
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(fetch, 32);
  return __shfl_sync(0xffffffffu, base, 0);
}

// persistent blocks of `kernel` at `block` threads and `smem` bytes of
// dynamic shared memory: as many as fit on every SM, found once per
// instantiation (for the current device), at most one per `block` lanes
// of n
template <typename Kernel>
int persistent_grid(Kernel kernel, int block, int* cache, int n,
                    size_t smem = 0) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                  smem);
    *cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  int need = (n + block - 1) / block;
  return need < *cache ? need : *cache;
}
