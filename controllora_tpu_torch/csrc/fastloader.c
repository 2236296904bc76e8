/* fastloader: the native data plane of the PyTorch port's trainers.
 *
 * The port's copy of native/fastloader.c with the same two routines, computing the
 * same bytes, behind a plain C interface that ctypes loads
 * (controllora_tpu_torch/data/fastloader.py), so the build needs no Python headers:
 *
 *   - fill50k_batch: rasterise a whole batch of fill50k samples (anti-aliased
 *     filled circle and ring guide, float32 NHWC in [-1, 1]), one pthread a slice
 *     of the batch;
 *   - normalize_u8: uint8 -> float32 in [-1, 1], one pthread a slice of the items.
 *
 * Build: cc -O3 -shared -fPIC -pthread fastloader.c -o libfastloader.so -lm
 */

#include <math.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* ---------------------------------------------------------------- threading */

typedef struct {
    void (*fn)(void *, int);
    void *ctx;
    int begin, end;
} task_t;

static void *worker(void *arg) {
    task_t *t = (task_t *)arg;
    for (int i = t->begin; i < t->end; i++) t->fn(t->ctx, i);
    return NULL;
}

static void parallel_for(void (*fn)(void *, int), void *ctx, int n, int nthreads) {
    if (nthreads > n) nthreads = n > 0 ? n : 1;
    if (nthreads <= 1) {
        task_t t = {fn, ctx, 0, n};
        worker(&t);
        return;
    }
    pthread_t threads[64];
    task_t tasks[64];
    if (nthreads > 64) nthreads = 64;
    int chunk = (n + nthreads - 1) / nthreads;
    int k = 0;
    for (int i = 0; i < nthreads; i++) {
        int b = i * chunk, e = b + chunk;
        if (b >= n) break;
        if (e > n) e = n;
        tasks[i].fn = fn; tasks[i].ctx = ctx; tasks[i].begin = b; tasks[i].end = e;
        pthread_create(&threads[i], NULL, worker, &tasks[i]);
        k++;
    }
    for (int i = 0; i < k; i++) pthread_join(threads[i], NULL);
}

/* ---------------------------------------------------------------- fill50k */

typedef struct {
    float *pixels;   /* (B, R, R, 3) */
    float *guides;   /* (B, R, R, 3) */
    const float *spec; /* (B, 9): cx, cy, radius, bg_r, bg_g, bg_b, fg_r, fg_g, fg_b */
    int res;
} fill_ctx_t;

static void fill_one(void *vctx, int b) {
    fill_ctx_t *c = (fill_ctx_t *)vctx;
    const int r = c->res;
    const float *s = c->spec + b * 9;
    const float cx = s[0], cy = s[1], rad = s[2];
    float bg[3] = {s[3], s[4], s[5]};
    float fg[3] = {s[6], s[7], s[8]};
    float *px = c->pixels + (size_t)b * r * r * 3;
    float *gd = c->guides + (size_t)b * r * r * 3;
    for (int y = 0; y < r; y++) {
        for (int x = 0; x < r; x++) {
            float dx = (float)x - cx, dy = (float)y - cy;
            float d = sqrtf(dx * dx + dy * dy);
            size_t o = ((size_t)y * r + x) * 3;
            /* filled circle with 1px anti-aliased edge */
            float a = d <= rad - 0.5f ? 1.f : (d >= rad + 0.5f ? 0.f : rad + 0.5f - d);
            for (int ch = 0; ch < 3; ch++) {
                float v = fg[ch] * a + bg[ch] * (1.f - a);
                px[o + ch] = v / 127.5f - 1.f;
            }
            /* ring guide: |d - rad| <= 1.5 */
            float g = fabsf(d - rad) <= 1.5f ? 1.f : -1.f;
            gd[o] = g; gd[o + 1] = g; gd[o + 2] = g;
        }
    }
}

/* ---------------------------------------------------------------- normalize */

typedef struct {
    const uint8_t *src;
    float *dst;
    size_t elems_per_item;
} norm_ctx_t;

static void norm_one(void *vctx, int i) {
    norm_ctx_t *c = (norm_ctx_t *)vctx;
    const uint8_t *s = c->src + (size_t)i * c->elems_per_item;
    float *d = c->dst + (size_t)i * c->elems_per_item;
    for (size_t j = 0; j < c->elems_per_item; j++)
        d[j] = (float)s[j] / 127.5f - 1.f;
}

/* ---------------------------------------------------------------- C interface */

/* spec: (batch, 9) float32; pixels, guides: (batch, res, res, 3) float32 */
void fill50k_batch(const float *spec, float *pixels, float *guides, int batch, int res,
                   int nthreads) {
    fill_ctx_t ctx = {pixels, guides, spec, res};
    parallel_for(fill_one, &ctx, batch, nthreads);
}

/* src: items * elems_per_item uint8; dst: as many float32 */
void normalize_u8(const uint8_t *src, float *dst, int items, size_t elems_per_item,
                  int nthreads) {
    norm_ctx_t ctx = {src, dst, elems_per_item};
    parallel_for(norm_one, &ctx, items, nthreads);
}
