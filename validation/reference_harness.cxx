// Ground-truth harness: renders with the REFERENCE's own header-only core.
//
// This file is new driver code that #includes the read-only reference
// sources (-I <reference>/src) -- raytracer.hxx's intersect/hit_world/
// apply_material, camera.hxx's camera, math.hxx -- and reproduces the
// reference CPU render loop (main.cxx:185-215) sequentially (avoiding the
// R1 shared-generator data race so the output is deterministic per seed).
// This renderer's statistical-parity test (tests/test_reference_parity
// .py) compares its image against this binary's output: the two use
// different RNGs, so agreement is asserted on converged means at high spp
// -- exactly the "validate allclose against the reference C++ renderer"
// requirement (BASELINE.md).
//
// Scene = the reference CPU scene (main.cxx:120-129); camera = the CPU
// camera (main.cxx:179-183) with aperture passed in (0 disables the Q2
// defocus draw's effect); integrator loop = app::color (main.cxx:52-75)
// with the bounce budget as an argument; sky parameter t = .5*y + 1
// (main.cxx:71, quirk Q6). Output: raw little-endian float32 RGB, H*W*3.
//
// Build: g++ -O2 -std=c++20 -I$REF/src reference_harness.cxx -o harness -ltbb
// Usage: harness W H SPP MAX_DEPTH SEED APERTURE OUT.BIN [SCENE.BIN [OUT.PPM]]
//   SCENE.BIN may be "-" to use the built-in CPU scene.
//   OUT.PPM additionally writes the reference's END PRODUCT: the gamma+u8
//   PPM, byte-for-byte as main.cxx does it -- gamma_correction
//   (math::pow(color, 1/2.2), main.cxx:39-45), normalize_rgb_to_8bit
//   (255*x raw uint8 cast, NO clamp, main.cxx:77-85), save_to_file's
//   "P6\nW H\n255\n" header + raw texels (main.cxx:87-101).
//
// SCENE.BIN (optional; default = the built-in CPU scene): little-endian
//   int32 S, M; then per sphere cx cy cz r (f32) + mat_index (i32); then
//   per material mtype (i32: 0 lambert, 1 metal, 2 dielectric) +
//   albedo r g b, fuzz, ior (f32). Written by tests/test_reference_parity
//   from the Python scene builders so BOTH renderers see the identical
//   scene (the reference's own huge-scene generator is dead code with a
//   dangling-material bug, SURVEY Q8).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "raytracer.hxx"
#include "camera.hxx"

namespace {

math::vec3 background_color(float t) {
    // main.cxx:47-50: mix(white, {.5,.7,1}, t), unclamped.
    return math::mix(math::vec3{1}, math::vec3{.5, .7, 1}, t);
}

math::vec3 color(raytracer::data &rt, math::ray ray, unsigned max_depth) {
    // main.cxx:52-75, with the bounce budget parameterized.
    math::vec3 attenuation{1};
    auto scattered_ray = ray;
    for (auto bounce = 0u; bounce < max_depth; ++bounce) {
        if (auto hit = raytracer::hit_world(rt.spheres, scattered_ray);
            hit) {
            if (auto scattered = raytracer::apply_material(rt, scattered_ray,
                                                           hit.value());
                scattered) {
                attenuation *= scattered->second;
                scattered_ray = scattered->first;
            } else {
                return math::vec3{0};
            }
        } else {
            return background_color(
                       .5f * scattered_ray.unit_direction().y + 1.f) *
                   attenuation;
        }
    }
    return math::vec3{0};
}

}  // namespace

int main(int argc, char **argv) {
    if (argc < 8 || argc > 10) {
        std::fprintf(
            stderr,
            "usage: %s W H SPP DEPTH SEED APERTURE OUT [SCENE [PPM]]\n",
            argv[0]);
        return 2;
    }
    int const width = std::atoi(argv[1]);
    int const height = std::atoi(argv[2]);
    int const spp = std::atoi(argv[3]);
    unsigned const max_depth = std::atoi(argv[4]);
    unsigned const seed = std::atoi(argv[5]);
    float const aperture = std::atof(argv[6]);

    raytracer::data rt;
    rt.generator.seed(seed);

    if (argc >= 9 && std::string_view{argv[8]} != "-") {
        std::FILE *sf = std::fopen(argv[8], "rb");
        if (!sf) return 3;
        std::int32_t ns = 0, nm = 0;
        if (std::fread(&ns, 4, 1, sf) != 1 ||
            std::fread(&nm, 4, 1, sf) != 1) return 3;
        for (std::int32_t i = 0; i < ns; ++i) {
            float c[4];
            std::int32_t mi;
            if (std::fread(c, 4, 4, sf) != 4 ||
                std::fread(&mi, 4, 1, sf) != 1) return 3;
            rt.spheres.emplace_back(math::vec3{c[0], c[1], c[2]}, c[3],
                                    static_cast<unsigned>(mi));
        }
        for (std::int32_t i = 0; i < nm; ++i) {
            std::int32_t mt;
            float v[5];
            if (std::fread(&mt, 4, 1, sf) != 1 ||
                std::fread(v, 4, 5, sf) != 5) return 3;
            math::vec3 alb{v[0], v[1], v[2]};
            if (mt == 0)
                rt.materials.emplace_back(material::lambert{alb});
            else if (mt == 1)
                rt.materials.emplace_back(material::metal{alb, v[3]});
            else
                rt.materials.emplace_back(material::dielectric{alb, v[4]});
        }
        std::fclose(sf);
    } else {
        // Scene: main.cxx:120-129 (CPU scene; hollow glass r = -.99).
        rt.materials.emplace_back(material::lambert{math::vec3{.1, .2, .5}});
        rt.materials.emplace_back(material::metal{math::vec3{.8, .6, .2}, 0});
        rt.materials.emplace_back(material::dielectric{math::vec3{1}, 1.5});
        rt.materials.emplace_back(material::lambert{math::vec3{.64, .8, 0}});

        rt.spheres.emplace_back(math::vec3{0, 1, 0}, 1.f, 0u);
        rt.spheres.emplace_back(math::vec3{0, -1000.125f, 0}, 1000.f, 3u);
        rt.spheres.emplace_back(math::vec3{+2, 1, 0}, 1.f, 1u);
        rt.spheres.emplace_back(math::vec3{-2, 1, 0}, 1.f, 2u);
        rt.spheres.emplace_back(math::vec3{-2, 1, 0}, -.99f, 2u);
    }

    // Camera: main.cxx:179-183.
    auto const position = math::vec3{-4, 3.2f, 5};
    auto const lookat = math::vec3{0, 1, 0};
    auto camera = raytracer::camera{
        position, lookat, math::vec3{0, 1, 0},
        static_cast<float>(width) / static_cast<float>(height), 42.f,
        aperture, math::distance(position, lookat)};

    std::uniform_real_distribution<float> u01{0.f, 1.f};
    std::vector<float> out(static_cast<size_t>(width) * height * 3);

    for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
            math::vec3 acc{0};
            for (int s = 0; s < spp; ++s) {
                // main.cxx:199-200 jitter.
                auto const u = (static_cast<float>(x) + u01(rt.generator)) /
                               static_cast<float>(width);
                auto const v = (static_cast<float>(y) + u01(rt.generator)) /
                               static_cast<float>(height);
                acc += color(rt, camera.ray(u, v), max_depth);
            }
            acc /= static_cast<float>(spp);
            auto const i = (static_cast<size_t>(y) * width + x) * 3;
            out[i + 0] = acc.x;
            out[i + 1] = acc.y;
            out[i + 2] = acc.z;
        }
    }

    std::FILE *f = std::fopen(argv[7], "wb");
    if (!f) return 1;
    std::fwrite(out.data(), sizeof(float), out.size(), f);
    std::fclose(f);

    if (argc == 10) {
        // The reference's end product, byte-exact: gamma_correction
        // (main.cxx:39-45) + normalize_rgb_to_8bit raw cast (77-85) +
        // save_to_file's header (96-100).
        auto constexpr gamma = math::vec3{1.f / 2.2f};
        std::vector<std::uint8_t> texels(out.size());
        for (std::size_t i = 0; i < out.size(); i += 3) {
            auto const c =
                math::pow(math::vec3{out[i], out[i + 1], out[i + 2]}, gamma);
            texels[i + 0] = static_cast<std::uint8_t>(255.f * c.x);
            texels[i + 1] = static_cast<std::uint8_t>(255.f * c.y);
            texels[i + 2] = static_cast<std::uint8_t>(255.f * c.z);
        }
        std::FILE *pf = std::fopen(argv[9], "wb");
        if (!pf) return 1;
        std::fprintf(pf, "P6\n%d %d\n255\n", width, height);
        std::fwrite(texels.data(), 1, texels.size(), pf);
        std::fclose(pf);
    }
    return 0;
}
