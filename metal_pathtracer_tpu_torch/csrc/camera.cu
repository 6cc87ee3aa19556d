// Primary rays: a sample's seeds, pixel jitter, lens draw and rays in one
// launch (primary_rays_kernel).
//
// Replaces no TPU kernel. The JAX package leaves ops/rng.py make_seed and
// ops/camera.py generate_primary_rays to XLA, which fuses the chain into a
// few loops. Eager PyTorch runs it (ops/kernels/camera.py
// primary_rays_reference) as 1,540 full-width int64, float32 and float64
// launches a wavefront, most of them the unit disk's 24 fixed rounds of
// masked rejection, and the device waits on the host's launches for all
// of it.
//
// Bits. Each lane does the plain chain's operations in its order: the
// seed in uint32 (make_seed's int64 sums masked to 32 bits wrap the same
// way), rand_uniform as __uint2float_rn(s) * 2^-32 (common.cuh), the
// jitter divided with __fdiv_rn (vecmath.fdiv), __fmaf_rn only where the
// plain chain calls vecmath.fma (the pixel, the disk's acceptance test,
// the lens offset), `* 2 - 1` as a multiply and a subtract; the build
// passes --fmad=false. The disk loop stops at the first accepted
// candidate: the masked rejection advances a lane's state only until it
// accepts, so its value and state are that round's, and a lane that never
// accepts keeps its 24th candidate and state, as here. The lens radius is
// a value, never a branch: at radius 0 the draw still advances the state.
//
// What bounds it on an H100: bytes. A lane reads x, y and its previous
// count (24 B, int64) and writes its state (8 B), origin and direction
// (24 B): 56 B, 51.6 MB at 1280x720, 0.0154 ms at 3.35 TB/s. Its work is
// ~4.5 PCG hashes and ~30 float operations in the mean (a round accepts
// with probability pi/4), and a warp runs as many rounds as its longest
// lane, ~4-5. One thread a lane; every thread reads the camera's 19
// floats at the same addresses through the read-only cache (a broadcast),
// so nothing is staged; the (N,3) rows go out 12 B a thread, which L2
// merges into whole sectors before they reach memory.
#include "common.cuh"

#define CAM_BLOCK 256
#define DISK_ROUNDS 24

namespace {

// CameraUniforms' tensors: origin, lower_left, horizontal, vertical, u, v
// (3 floats each), lens_radius (1)
struct Camera {
  const float* p[7];
};

__device__ __forceinline__ V3 ldg3(const float* p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

__global__ void __launch_bounds__(CAM_BLOCK) primary_rays_kernel(
    int n, const long long* __restrict__ x, const long long* __restrict__ y,
    const long long* __restrict__ prev, uint32_t fixed_seed,
    uint32_t frame_index, uint32_t sample_count, float width, float height,
    Camera cam, long long* __restrict__ out_state, float* __restrict__ out_o,
    float* __restrict__ out_d) {
  int i = blockIdx.x * CAM_BLOCK + threadIdx.x;
  if (i >= n) return;
  long long xi = x[i], yi = y[i];
  // rng.make_seed
  uint32_t s = fixed_seed + frame_index * 9781u + (uint32_t)xi * 6271u +
               (uint32_t)yi * 13007u +
               (sample_count + (uint32_t)prev[i]) * 211u;
  // camera.generate_primary_rays: the jitter and the pixel
  float jx = rand_uniform(&s);
  float u = __fdiv_rn(__ll2float_rn(xi) + jx, width);
  float jy = rand_uniform(&s);
  float v = 1.0f - __fdiv_rn(__ll2float_rn(yi) + jy, height);
  V3 pixel = fma3(v, ldg3(cam.p[3]), fma3(u, ldg3(cam.p[2]), ldg3(cam.p[1])));
  // rng.random_in_unit_disk
  float d0 = 0.0f, d1 = 0.0f;
  for (int k = 0; k < DISK_ROUNDS; ++k) {
    d0 = rand_uniform(&s) * 2.0f - 1.0f;
    d1 = rand_uniform(&s) * 2.0f - 1.0f;
    if (__fmaf_rn(d1, d1, d0 * d0) < 1.0f) break;
  }
  float lens = __ldg(cam.p[6]);
  d0 = lens * d0;
  d1 = lens * d1;
  V3 cu = ldg3(cam.p[4]), cv = ldg3(cam.p[5]);
  V3 offset = v3(__fmaf_rn(d0, cu.x, d1 * cv.x), __fmaf_rn(d0, cu.y, d1 * cv.y),
                 __fmaf_rn(d0, cu.z, d1 * cv.z));
  V3 origin = ldg3(cam.p[0]) + offset;
  out_state[i] = (long long)s;
  store3(out_o, i, origin);
  store3(out_d, i, pixel - origin);
}

}  // namespace

// x, y, prev: (n,) int64; camera: host void*[7] of CameraUniforms' device
// pointers (origin, lower_left, horizontal, vertical, u, v, lens_radius);
// out: (n,) int64 state, (n, 3) float32 origin and direction
extern "C" int mpt_primary_rays(int n, const void* x, const void* y,
                                const void* prev, uint32_t fixed_seed,
                                uint32_t frame_index, uint32_t sample_count,
                                float width, float height,
                                const void* const* camera, void* out_state,
                                void* out_o, void* out_d, void* stream) {
  if (n <= 0) return 0;
  Camera cam;
  for (int k = 0; k < 7; ++k) cam.p[k] = (const float*)camera[k];
  primary_rays_kernel<<<(n + CAM_BLOCK - 1) / CAM_BLOCK, CAM_BLOCK, 0,
                        (cudaStream_t)stream>>>(
      n, (const long long*)x, (const long long*)y, (const long long*)prev,
      fixed_seed, frame_index, sample_count, width, height, cam,
      (long long*)out_state, (float*)out_o, (float*)out_d);
  return (int)cudaGetLastError();
}
