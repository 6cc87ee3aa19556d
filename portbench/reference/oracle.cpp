// The benchmark's plain reference: a scalar CPU path tracer that decides
// `correct` (portbench/check.py).
//
// Cut from the repository's independent CPU oracle (native/cpu_oracle.cpp),
// the parity backend that plays the role of upstream's Embree renderer
// (src/headless/EmbreeHeadlessRenderer.mm): written against the upstream
// shader's behavioural spec (pathtrace.metal), sharing with the program only
// that spec and the PCG recipe that seeds each pixel sample, so that a
// sample of the program and of this file follow the same path wherever
// their float rounding does not part them. It is kept here, apart from the
// program and from the copy in native/, so that no change elsewhere changes
// the yardstick.
//
// What the benchmark's scenes use, and nothing else: spheres; lambert,
// metal (GGX, or a mirror below roughness 1e-3) and dielectric materials
// with Beer-Lambert absorption inside; the gradient or a solid background;
// the firefly clamps and Russian roulette. Without lights, environment or
// MNEE the oracle's light integrals (rectangle and environment NEE,
// specular-NEE chains) add nothing and draw nothing, so they are left out.
// The entry point renders a list of pixels and returns each pixel's
// radiance sum over samples 0 .. spp - 1 in sample order; `control` rounds
// the path state (origin, direction, throughput, radiance) to bfloat16
// after every depth, the benchmark's control one precision below the
// configurations' float32.
//
// Build: g++ -O3 -march=x86-64-v3 -ffp-contract=off -fPIC -shared -std=c++17
// -pthread
// (portbench/reference/oracle.py builds it on first use).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInfinity = 1e20f;
constexpr float kEpsilon = 1e-3f;
constexpr float kRayOriginEpsilon = 1e-4f;
constexpr int kMaxMedium = 8;

struct V3 {
    float x = 0, y = 0, z = 0;
};
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 operator*(float s, V3 a) { return a * s; }
inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
inline V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float length(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalize(V3 a) {
    float l = length(a);
    return l > 0 ? a / l : V3{0, 0, 0};
}
inline V3 vmin0(V3 a) { return {std::max(a.x, 0.f), std::max(a.y, 0.f), std::max(a.z, 0.f)}; }
inline float maxc(V3 a) { return std::max(a.x, std::max(a.y, a.z)); }
inline bool finite3(V3 a) {
    return std::isfinite(a.x) && std::isfinite(a.y) && std::isfinite(a.z);
}
inline float luminance(V3 c) {
    return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}
inline V3 vexp(V3 a) { return {std::exp(a.x), std::exp(a.y), std::exp(a.z)}; }
inline V3 reflect(V3 v, V3 n) { return v - 2.0f * dot(v, n) * n; }
inline V3 refract(V3 v, V3 n, float eta) {
    float cosi = -dot(v, n);
    float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
    if (k < 0.0f) return {0, 0, 0};
    return eta * v + (eta * cosi - std::sqrt(k)) * n;
}

// ---- RNG: bit-identical to ops/rng.py / pathtrace.metal:55-64 -----------
inline uint32_t pcg_hash(uint32_t s) {
    s = s * 747796405u + 2891336453u;
    uint32_t w = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
    return (w >> 22u) ^ w;
}
inline float rand_uniform(uint32_t& s) {
    s = pcg_hash(s);
    return static_cast<float>(s) / 4294967296.0f;
}
inline void disk_sample(uint32_t& s, float& ox, float& oy) {
    while (true) {
        float a = rand_uniform(s) * 2.0f - 1.0f;
        float b = rand_uniform(s) * 2.0f - 1.0f;
        if (a * a + b * b < 1.0f) {
            ox = a;
            oy = b;
            return;
        }
    }
}
inline void build_onb(V3 n, V3& t, V3& b) {
    V3 up = std::fabs(n.z) < 0.999f ? V3{0, 0, 1} : V3{1, 0, 0};
    t = normalize(cross(up, n));
    b = cross(n, t);
}
inline V3 to_world(V3 local, V3 n) {
    V3 t, b;
    build_onb(n, t, b);
    return local.x * t + local.y * b + local.z * n;
}
inline V3 cosine_hemisphere(uint32_t& s) {
    float r1 = rand_uniform(s);
    float r2 = rand_uniform(s);
    float phi = 2.0f * kPi * r2;
    float r = std::sqrt(std::max(r1, 0.0f));
    return {std::cos(phi) * r, std::sin(phi) * r,
            std::sqrt(std::max(1.0f - r1, 0.0f))};
}

// ---- scene data ----------------------------------------------------------
struct Material {
    V3 base_color;
    float roughness;
    int type;  // 0 lambert, 1 metal, 2 dielectric
    float eta;
    float thin;
    V3 sigma_a;  // dielectric absorption
};

struct Scene {
    int n_spheres = 0;
    const float* sph = nullptr;  // (S,4) center+radius
    const int* sph_mat = nullptr;
    std::vector<Material> mats;
};

struct Hit {
    bool hit = false;
    float t = kInfinity;
    V3 point, normal;
    bool front = false, two_sided = false;
    int mat = 0;
    int prim_type = 0;  // 1 sphere
    int prim = -1;
};

struct Clamps {
    float factor, floor_, throughput, max_contribution, enabled;
};

// ---- intersection (reference math: pathtrace.metal:1239-1319, 544-592) --
bool hit_spheres(const Scene& sc, V3 o, V3 d, float tmin, float tmax, Hit& out) {
    bool any = false;
    float closest = tmax;
    for (int i = 0; i < sc.n_spheres; ++i) {
        V3 c = {sc.sph[4 * i], sc.sph[4 * i + 1], sc.sph[4 * i + 2]};
        float r = sc.sph[4 * i + 3];
        V3 oc = o - c;
        float a = dot(d, d);
        float hb = dot(oc, d);
        float cc = dot(oc, oc) - r * r;
        float disc = hb * hb - a * cc;
        if (disc < 0) continue;
        float sq = std::sqrt(disc);
        float root = (-hb - sq) / a;
        if (root < tmin || root > closest) {
            root = (-hb + sq) / a;
            if (root < tmin || root > closest) continue;
        }
        closest = root;
        out.hit = true;
        out.t = root;
        out.point = o + d * root;
        V3 outward = (out.point - c) / r;
        out.front = dot(d, outward) < 0;
        out.normal = out.front ? outward : outward * -1.0f;
        out.two_sided = true;
        out.mat = sc.sph_mat[i];
        out.prim_type = 1;
        out.prim = i;
        any = true;
    }
    return any;
}

bool trace(const Scene& sc, V3 o, V3 d, float tmin, float tmax, Hit& out) {
    out = Hit{};
    out.t = tmax;
    return hit_spheres(sc, o, d, tmin, tmax, out);
}

V3 offset_origin(const Hit& h, V3 dir) {
    V3 n = h.normal;
    float sign = dot(dir, n) >= 0 ? 1.0f : -1.0f;
    float dist = std::max(std::fabs(h.t) * 1e-4f, kRayOriginEpsilon);
    return h.point + n * (sign * dist) + dir * (kRayOriginEpsilon * 0.5f);
}

// ---- clamps (reference: pathtrace.metal clamp_*) -------------------------
V3 clamp_contribution(V3 tp, V3 c, const Clamps& p) {
    V3 comb = tp * c;
    if (!finite3(comb)) return {0, 0, 0};
    V3 pos = vmin0(comb);
    if (p.enabled < 0.5f) return pos;
    float lum = luminance(pos);
    float tl = luminance(vmin0(tp));
    float ml = std::max(tl * p.factor, p.floor_);
    if (p.max_contribution > 0) ml = std::max(ml, p.max_contribution);
    if (lum > ml && lum > 0) {
        comb = comb * (ml / std::max(lum, 1e-6f));
        pos = vmin0(comb);
    }
    return pos;
}
V3 clamp_throughput(V3 tp, const Clamps& p) {
    if (!finite3(tp)) return {0, 0, 0};
    if (p.enabled < 0.5f || p.throughput <= 0) return tp;
    float lum = luminance(vmin0(tp));
    if (lum > p.throughput && lum > 0)
        return tp * (p.throughput / std::max(lum, 1e-6f));
    return tp;
}

// ---- Fresnel / GGX (reference: pathtrace.metal:3645-3911) ----------------
float fresnel_dielectric(float ci, float etai, float etat, float& cost) {
    ci = std::clamp(ci, -1.0f, 1.0f);
    float aci = std::fabs(ci);
    float s2i = std::max(0.0f, 1.0f - aci * aci);
    float eta = etai / etat;
    float s2t = eta * eta * s2i;
    if (s2t >= 1.0f) {
        cost = 0;
        return 1.0f;
    }
    cost = std::sqrt(std::max(1.0f - s2t, 0.0f));
    float rs = (etai * aci - etat * cost) / (etai * aci + etat * cost);
    float rp = (etat * aci - etai * cost) / (etat * aci + etai * cost);
    return 0.5f * (rs * rs + rp * rp);
}
float schlick_w(float c) {
    float m = std::clamp(1.0f - c, 0.0f, 1.0f);
    return m * m * m * m * m;
}
V3 schlick(V3 f0, float c) {
    float w = schlick_w(c);
    return f0 + (V3{1, 1, 1} - f0) * w;
}
float ggx_lambda(float a, float c) {
    float ac = std::fabs(c);
    if (ac <= 0) return 0;
    float s = std::sqrt(std::max(0.0f, 1.0f - ac * ac));
    if (s == 0) return 0;
    float t = s / ac, aa = a * t;
    return (-1.0f + std::sqrt(1.0f + aa * aa)) * 0.5f;
}
float ggx_g1(float a, float c) { return 1.0f / (1.0f + ggx_lambda(a, c)); }
float ggx_d(float a, float ch) {
    float ac = std::fabs(ch), a2 = a * a;
    float den = ac * ac * (a2 - 1.0f) + 1.0f;
    return a2 / (kPi * den * den);
}
float ggx_pdf(float a, V3 n, V3 wo, V3 wi) {
    V3 wh = normalize(wo + wi);
    float ch = dot(n, wh), dwh = dot(wo, wh), co = dot(n, wo);
    if (co <= 0 || ch <= 0 || dwh <= 0) return 0;
    return ggx_d(a, ch) * ggx_g1(a, co) * ch / (4.0f * std::max(dwh, 1e-6f));
}
V3 to_local(V3 v, V3 n) {
    V3 t, b;
    build_onb(n, t, b);
    return {dot(v, t), dot(v, b), dot(v, n)};
}
V3 sample_vndf(V3 n, V3 wo, float rough, uint32_t& s) {
    V3 wol = to_local(normalize(wo), n);
    wol.z = std::max(wol.z, 1e-6f);
    float a = std::max(rough * rough, 1e-4f);
    V3 vh = normalize({a * wol.x, a * wol.y, wol.z});
    float lensq = vh.x * vh.x + vh.y * vh.y;
    V3 t1 = lensq > 0 ? V3{-vh.y, vh.x, 0} * (1.0f / std::sqrt(lensq))
                      : V3{1, 0, 0};
    V3 t2 = cross(vh, t1);
    float u1 = rand_uniform(s), u2 = rand_uniform(s);
    float r = std::sqrt(u1), phi = 2.0f * kPi * u2;
    float p1 = r * std::cos(phi), p2 = r * std::sin(phi);
    float sfac = 0.5f * (1.0f + vh.z);
    float p2a = (1.0f - sfac) * std::sqrt(std::max(0.0f, 1.0f - p1 * p1)) + sfac * p2;
    float p3 = std::sqrt(std::max(0.0f, 1.0f - p1 * p1 - p2a * p2a));
    V3 nh = p1 * t1 + p2a * t2 + p3 * vh;
    V3 ne = normalize({a * nh.x, a * nh.y, std::max(nh.z, 0.0f)});
    return normalize(to_world(ne, n));
}
void dfg_approx(float rough, float nov, float& x, float& y) {
    const float c0[4] = {-1.0f, -0.0275f, -0.572f, 0.022f};
    const float c1[4] = {1.0f, 0.0425f, 1.04f, -0.04f};
    float r[4];
    for (int i = 0; i < 4; ++i) r[i] = rough * c0[i] + c1[i];
    float a004 = std::min(r[0] * r[0], std::exp2(-9.28f * nov)) * r[0] + r[1];
    x = -1.04f * a004 + r[2];
    y = 1.04f * a004 + r[3];
}
V3 energy_comp(V3 f0, float rough, float nov) {
    float x, y;
    dfg_approx(rough, std::clamp(nov, 0.0f, 1.0f), x, y);
    auto comp = [&](float f) {
        float fss = std::clamp(f * x + y, 0.0f, 0.99f);
        float favg = f + (1.0f - f) / 21.0f;
        float om = std::clamp(1.0f - fss, 0.0f, 1.0f);
        float fms = (favg * om) / std::max(1.0f - favg * om, 1e-3f);
        return std::clamp((fss + fms) / std::max(fss, 1e-4f), 1.0f, 2.0f);
    };
    return {comp(f0.x), comp(f0.y), comp(f0.z)};
}

struct SampleResult {
    V3 dir, weight;
    float pdf = 0, dpdf = 0;
    bool delta = false;
    int medium_event = 0;
};
// a metal's F0 is its base colour (no complex IOR in the benchmark's scenes)
V3 conductor_f0(const Material& m) {
    return {std::clamp(m.base_color.x, 0.f, 1.f), std::clamp(m.base_color.y, 0.f, 1.f),
            std::clamp(m.base_color.z, 0.f, 1.f)};
}
SampleResult sample_bsdf(const Material& m, V3 n, V3 wo, V3 incident,
                         bool front, uint32_t& s) {
    SampleResult r;
    switch (m.type) {
        case 0: {
            V3 local = cosine_hemisphere(s);
            V3 wi = normalize(to_world(local, n));
            float ci = dot(n, wi);
            if (ci <= 0) return r;
            float pdf = ci / kPi;
            if (pdf <= 0) return r;
            r.dir = wi;
            r.weight = m.base_color;
            r.pdf = r.dpdf = pdf;
            break;
        }
        case 1: {
            float rough = std::clamp(m.roughness, 0.f, 1.f);
            V3 f0 = conductor_f0(m);
            if (rough <= 1e-3f) {
                V3 wi = reflect(incident, n);
                if (dot(n, wi) <= 0) return r;
                float ct = std::max(dot(n, wo), 0.0f);
                r.weight = schlick(f0, ct);
                r.dir = wi;
                r.pdf = r.dpdf = 1.0f;
                r.delta = true;
                break;
            }
            float a = rough * rough;
            V3 wh = sample_vndf(n, wo, rough, s);
            if (dot(wh, n) <= 0) return r;
            V3 wi = normalize(reflect(wo * -1.0f, wh));
            float ci = dot(n, wi), co = dot(n, wo);
            if (ci <= 0 || co <= 0 || dot(wo, wh) <= 0) return r;
            float D = ggx_d(a, dot(n, wh));
            float G = ggx_g1(a, co) * ggx_g1(a, ci);
            V3 F = schlick(f0, dot(wi, wh));
            V3 f = F * (D * G / std::max(4.0f * co * ci, 1e-6f));
            f = f * energy_comp(f0, rough, co);
            float pdf = ggx_pdf(a, n, wo, wi);
            if (pdf <= 0) return r;
            r.dir = wi;
            r.weight = vmin0(f * (ci / pdf));
            r.pdf = r.dpdf = pdf;
            break;
        }
        case 2: {
            bool thin = m.thin > 0.5f;
            float ref = std::max(m.eta, 1.0f);
            float ei = 1.0f, et = ref;
            if (!thin && !front) {
                ei = ref;
                et = 1.0f;
            }
            float co = std::clamp(dot(incident * -1.0f, n), -1.0f, 1.0f);
            float ct = 0;
            float Fr = fresnel_dielectric(co, ei, et, ct);
            V3 dir;
            V3 weight;
            if (rand_uniform(s) < Fr) {
                dir = reflect(incident, n);
                weight = {Fr, Fr, Fr};
            } else {
                dir = refract(incident, n, ei / et);
                if (dot(dir, dir) <= 0) {
                    dir = reflect(incident, n);
                    weight = {Fr, Fr, Fr};
                } else {
                    dir = normalize(dir);
                    float esc = (et * et) / (ei * ei);
                    float w = std::max(1.0f - Fr, 0.0f) * esc *
                              (std::fabs(ct) / std::max(std::fabs(co), 1e-6f));
                    weight = {w, w, w};
                    if (!thin) r.medium_event = front ? 1 : -1;
                }
            }
            r.dir = normalize(dir);
            r.weight = weight;
            r.pdf = r.dpdf = 1.0f;
            r.delta = true;
            break;
        }
        default:
            break;
    }
    return r;
}

struct Params {
    int width, height, spp, max_depth;
    uint32_t seed;
    int use_rr;
    float cam[19];  // origin, lower_left, horizontal, vertical, u, v, lens_r
    int bg_mode;
    V3 bg_color;
    Clamps clamps;
    int control = 0;  // round the path state to bfloat16 after every depth
};

// round to the nearest bfloat16 (ties to even), kept in a float
inline float bf16(float x) {
    if (!std::isfinite(x)) return x;
    uint32_t u;
    std::memcpy(&u, &x, 4);
    u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
    std::memcpy(&x, &u, 4);
    return x;
}
inline V3 bf16(V3 a) { return {bf16(a.x), bf16(a.y), bf16(a.z)}; }

V3 sky(V3 d) {
    V3 u = normalize(d);
    float t = 0.5f * (u.y + 1.0f);
    return V3{1, 1, 1} * (1.0f - t) + V3{0.5f, 0.7f, 1.0f} * t;
}

V3 trace_path(const Scene& sc, const Params& P, V3 ro, V3 rd, uint32_t& s) {
    V3 throughput = {1, 1, 1};
    V3 radiance = {0, 0, 0};
    V3 medium[kMaxMedium];
    int medium_depth = 0;

    for (int depth = 0; depth < P.max_depth; ++depth) {
        Hit rec;
        if (!trace(sc, ro, rd, kEpsilon, kInfinity, rec)) {
            V3 bg = P.bg_mode == 1 ? P.bg_color : sky(rd);
            radiance = radiance + clamp_contribution(throughput, bg, P.clamps);
            break;
        }

        if (medium_depth > 0) {
            V3 sg = medium[medium_depth - 1];
            if (maxc(sg) > 0)
                throughput = throughput * vexp(sg * -std::max(rec.t, 0.0f));
        }

        const Material& m = sc.mats[std::min(rec.mat, (int)sc.mats.size() - 1)];
        V3 incident = normalize(rd);
        V3 wo = incident * -1.0f;
        V3 n = rec.normal;

        SampleResult smp = sample_bsdf(m, n, wo, incident, rec.front, s);
        if (smp.pdf <= 0) break;

        if (smp.medium_event == 1) {
            V3 sg = vmin0(m.sigma_a);
            if (medium_depth < kMaxMedium)
                medium[medium_depth++] = sg;
            else
                medium[kMaxMedium - 1] = sg;
        } else if (smp.medium_event == -1) {
            if (medium_depth > 0) medium_depth--;
        }

        V3 next_o = offset_origin(rec, smp.dir);

        throughput = clamp_throughput(throughput * smp.weight, P.clamps);
        if (!finite3(throughput)) break;
        float mtp = maxc(throughput);
        if (mtp <= 0) break;

        ro = next_o;
        rd = smp.dir;

        if (P.use_rr && depth >= 5) {
            float cp = std::clamp(mtp, 0.05f, 0.95f);
            if (rand_uniform(s) > cp) break;
            throughput = throughput / cp;
        }
        if (P.control) {
            ro = bf16(ro);
            rd = bf16(rd);
            throughput = bf16(throughput);
            radiance = bf16(radiance);
        }
    }
    return radiance;
}

}  // namespace

// Each listed pixel's radiance summed over samples 0 .. spp - 1 in order.
// mat_data: (M, 8) base colour, roughness, type, IOR, thin, and 0 (a metal
// takes its base colour as F0). sph: (S, 4) centre and
// radius. cam: origin, lower-left corner, horizontal, vertical, lens u, v,
// lens radius (19 floats). firefly: factor, floor, throughput clamp,
// largest contribution, enabled. Returns 0, or -1 for a material type the
// reference does not know.
extern "C" int render_pixels(
    int width, int height, int n_pix, const int* pix, int spp, int max_depth,
    uint32_t seed, int use_rr, int control, const float* cam, int bg_mode,
    const float* bg_color, int n_spheres, const float* sph, const int* sph_mat,
    int n_mats, const float* mat_data, const float* sigma_a,
    const float* firefly, int n_threads, float* out_sum) {
    Scene sc;
    sc.n_spheres = n_spheres;
    sc.sph = sph;
    sc.sph_mat = sph_mat;
    sc.mats.resize(n_mats);
    for (int i = 0; i < n_mats; ++i) {
        const float* d = mat_data + 8 * i;
        Material& m = sc.mats[i];
        m.base_color = {std::clamp(d[0], 0.f, 1.f), std::clamp(d[1], 0.f, 1.f),
                        std::clamp(d[2], 0.f, 1.f)};
        m.roughness = d[3];
        m.type = static_cast<int>(d[4]);
        if (m.type < 0 || m.type > 2) return -1;
        m.eta = d[5];
        m.thin = d[6];
        m.sigma_a = {sigma_a[3 * i], sigma_a[3 * i + 1], sigma_a[3 * i + 2]};
    }

    Params P;
    P.width = width;
    P.height = height;
    P.spp = spp;
    P.max_depth = max_depth;
    P.seed = seed;
    P.use_rr = use_rr;
    std::memcpy(P.cam, cam, sizeof(float) * 19);
    P.bg_mode = bg_mode;
    P.bg_color = {bg_color[0], bg_color[1], bg_color[2]};
    P.clamps = {firefly[0], firefly[1], firefly[2], firefly[3], firefly[4]};
    P.control = control;

    V3 cam_origin = {cam[0], cam[1], cam[2]};
    V3 lower_left = {cam[3], cam[4], cam[5]};
    V3 horizontal = {cam[6], cam[7], cam[8]};
    V3 vertical = {cam[9], cam[10], cam[11]};
    V3 cam_u = {cam[12], cam[13], cam[14]};
    V3 cam_v = {cam[15], cam[16], cam[17]};
    float lens_r = cam[18];

    // chunks of 16 listed pixels, atomic work index
    const int chunk = 16;
    const int n_chunks = (n_pix + chunk - 1) / chunk;
    std::atomic<int> next{0};
    int workers = n_threads > 0
                      ? n_threads
                      : static_cast<int>(std::thread::hardware_concurrency());
    workers = std::max(workers, 1);

    auto work = [&]() {
        while (true) {
            int c = next.fetch_add(1);
            if (c >= n_chunks) break;
            for (int k = c * chunk; k < std::min(c * chunk + chunk, n_pix); ++k) {
                int x = pix[k] % width, y = pix[k] / width;
                V3 sum = {0, 0, 0};
                for (int sidx = 0; sidx < spp; ++sidx) {
                    // seed recipe (reference: pathtrace.metal:9735-9740);
                    // frameIndex == sampleCount == previousCount == sidx
                    uint32_t s = P.seed + static_cast<uint32_t>(sidx) * 9781u +
                                 static_cast<uint32_t>(x) * 6271u +
                                 static_cast<uint32_t>(y) * 13007u +
                                 2u * static_cast<uint32_t>(sidx) * 211u;
                    float ju = rand_uniform(s);
                    float u = (x + ju) / width;
                    float jv = rand_uniform(s);
                    float v = 1.0f - (y + jv) / height;
                    float dx, dy;
                    disk_sample(s, dx, dy);
                    V3 off = cam_u * (lens_r * dx) + cam_v * (lens_r * dy);
                    V3 ro = cam_origin + off;
                    V3 rd = lower_left + horizontal * u + vertical * v - ro;
                    if (P.control) {
                        ro = bf16(ro);
                        rd = bf16(rd);
                    }
                    V3 rad = trace_path(sc, P, ro, rd, s);
                    if (finite3(rad)) sum = sum + vmin0(rad);
                }
                float* o = out_sum + 3 * k;
                o[0] = sum.x;
                o[1] = sum.y;
                o[2] = sum.z;
            }
        }
    };
    std::vector<std::thread> threads;
    for (int i = 1; i < workers; ++i) threads.emplace_back(work);
    work();
    for (auto& th : threads) th.join();
    return 0;
}
