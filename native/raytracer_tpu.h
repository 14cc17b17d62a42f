/* C ABI for the raytracer_tpu native runtime.
 *
 * Mirror of the reference's cbindgen-generated header
 * (/root/reference/MacOSPlatform/MacOSPlatform/Engine/includes/raytracer.h:
 * opaque world handle, RGBA8 framebuffer struct, and the three entry points
 * load_world / render / move_camera_position, lib.rs:38-63), extended with
 * explicit destroy/options/error functions that the reference leaves
 * implicit.
 *
 * The native engine renders on the host CPU with the exact reference
 * algorithm (single xorshift32 stream, seed 2547549) in parity mode, or a
 * thread-parallel counter-based mode ("fast") matching the JAX path's
 * sampling scheme.  The accelerated compute path itself lives in the
 * Python/JAX layer; this library is the embedding runtime for C/C++/Swift
 * hosts.
 */

#ifndef RAYTRACER_TPU_H
#define RAYTRACER_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* RGBA8 pixel — reference Rust_ColorU8 (color.rs:3-10). */
typedef struct RtColorU8 {
  uint8_t r, g, b, a;
} RtColorU8;

/* Caller-owned framebuffer — reference Rust_CFramebuffer (lib.rs:22-27). */
typedef struct RtFramebuffer {
  size_t width;
  size_t height;
  RtColorU8 *pixels; /* row-major, width*height entries */
} RtFramebuffer;

/* Opaque world handle — reference Rust_WorldHandle (lib.rs:29-33). */
typedef struct RtWorldHandle RtWorldHandle;

typedef struct RtRenderOptions {
  int32_t samples_per_pixel;  /* reference FFI default: 16 (lib.rs:51) */
  int32_t max_ray_bounces;    /* reference FFI default: 8 (lib.rs:51) */
  uint32_t seed;              /* 0 -> default 2547549 (random.rs:9) */
  int32_t parity;             /* 1: exact sequential reference stream;
                                 0: counter-based, thread-parallel */
  int32_t num_threads;        /* fast mode only; 0 -> hardware count */
} RtRenderOptions;

/* Parse a NUL-terminated scene-DSL source (parser.rs grammar) into a world.
 * Returns NULL on parse error; rt_last_error() describes it.
 * (lib.rs:38-46) */
RtWorldHandle *rt_load_world(const char *source);

/* Parse with explicit length (the reference's own TODO, lib.rs:35-36). */
RtWorldHandle *rt_load_world_n(const char *source, size_t len);

void rt_destroy_world(RtWorldHandle *world);

/* Render into the caller's framebuffer (lib.rs:50-57).  Returns 0 on
 * success.  NULL options -> reference FFI defaults (16 spp, 8 bounces,
 * parity). */
int rt_render(RtFramebuffer framebuffer, const RtWorldHandle *world,
              const RtRenderOptions *options);

/* Rebuild the world's camera at an offset origin, same aspect
 * (lib.rs:60-63). */
void rt_move_camera_position(RtWorldHandle *world, float x, float y, float z);

/* Camera origin accessor (camera.rs:91-93). */
void rt_camera_position(const RtWorldHandle *world, float out_xyz[3]);

/* ASCII PPM (P3) writer, byte-identical to image.rs:59-81.  path == NULL
 * writes to stdout.  Returns 0 on success. */
int rt_write_ppm(const RtFramebuffer *framebuffer, const char *path);

/* Last error message for this thread ("" if none). */
const char *rt_last_error(void);

/* Library version. */
const char *rt_version(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* RAYTRACER_TPU_H */
