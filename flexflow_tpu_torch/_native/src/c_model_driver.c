/* A pure-C host driving the PyTorch/CUDA port end to end through the
 * model C API (model_capi.cc beside this file, in the port's
 * libffcore.so).
 *
 *   c_model_driver DEVICE [WIDTH HEADS SEQ BATCH LAYERS STEPS]
 *
 * DEVICE is "cuda" or "cpu". First the loop of the JAX package's
 * tests/native/c_model_driver.c: the MLP_Unify shape (dense / relu /
 * dense / softmax) built through the dedicated entry points and the
 * generic JSON builder, grad_accum_steps 2 from the JSON config, 5 SGD
 * steps on a deterministic batch, a forward pass whose softmax rows sum
 * to 1; it prints C_MODEL_OK when the loss fell. Then LAYERS
 * multi-head attention layers (ffc_model_mha, WIDTH wide, HEADS heads,
 * over BATCH x SEQ x WIDTH inputs) under a dense layer, STEPS SGD steps
 * on a mean-squared error; it prints C_MHA_OK when the loss fell. Every
 * step's loss is printed ("mlp step i loss x", "mha step i loss x"). At
 * exit it prints the flash kernels' launch counts through the
 * interpreter the C API embeds ("FLASH_LAUNCHES {...}").
 *
 * Build (the port's library builds when flexflow_tpu_torch._native is
 * first imported):
 *   gcc -O1 c_model_driver.c -I native/include -I <python include>
 *       -L flexflow_tpu_torch/_native/_build -lffcore -L <python libdir>
 *       -lpython3.12 -Wl,-rpath,... -o c_model_driver
 * and run it with PYTHONPATH holding the checkout.
 */
#include <Python.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "ffcore.h"

#define BATCH 16
#define IN_DIM 32
#define CLASSES 8

static unsigned lcg_state = 12345u;

/* uniform in [-1, 1) from a 32-bit LCG (the JAX package's driver's) */
static double lcg_uniform(void) {
  lcg_state = lcg_state * 1103515245u + 12345u;
  return ((double)(lcg_state >> 16 & 0x7fff) / 32768.0 - 0.5) * 2.0;
}

static unsigned lcg_next(void) {
  lcg_state = lcg_state * 1103515245u + 12345u;
  return lcg_state;
}

static int mlp_leg(const char *device) {
  char config[256];
  snprintf(config, sizeof config,
           "{\"batch_size\": 16, \"workers_per_node\": 1, \"num_nodes\": 1,"
           " \"search_budget\": 0, \"grad_accum_steps\": 2, \"device\": \"%s\"}",
           device);
  ffc_model_t *m = ffc_model_create_json(config);
  if (!m) {
    fprintf(stderr, "ffc_model_create_json failed\n");
    return 1;
  }
  int64_t dims[2] = {BATCH, IN_DIM};
  int64_t x = ffc_model_input(m, dims, 2, "x");
  int64_t h = ffc_model_dense(m, x, 64, "relu", "fc1");
  char spec[256];
  snprintf(spec, sizeof spec,
           "{\"args\": [{\"__tensor__\": %lld}, %d],"
           " \"kwargs\": {\"name\": \"fc2\"}}",
           (long long)h, CLASSES);
  int64_t h2 = ffc_model_call(m, "dense", spec);
  int64_t sm = ffc_model_softmax(m, h2, "sm");
  if (x < 0 || h < 0 || h2 < 0 || sm < 0) {
    fprintf(stderr, "graph build failed\n");
    return 1;
  }
  if (ffc_model_compile(m, 0.05, "sparse_categorical_crossentropy") != 0) {
    fprintf(stderr, "compile failed\n");
    return 1;
  }
  static double xb[BATCH * IN_DIM];
  static double yb[BATCH];
  lcg_state = 12345u;
  for (int i = 0; i < BATCH * IN_DIM; ++i) xb[i] = lcg_uniform();
  for (int i = 0; i < BATCH; ++i) yb[i] = (double)(lcg_next() % CLASSES);
  int64_t xshape[2] = {BATCH, IN_DIM};
  int64_t yshape[1] = {BATCH};
  double first = -1.0, last = -1.0;
  for (int step = 0; step < 5; ++step) {
    double loss = ffc_model_fit_step(m, xb, xshape, 2, yb, yshape, 1, 1);
    if (loss < 0.0) {
      fprintf(stderr, "fit_step failed at %d\n", step);
      return 1;
    }
    if (step == 0) first = loss;
    last = loss;
    printf("mlp step %d loss %.9g\n", step, loss);
  }
  static double probs[BATCH * CLASSES];
  int64_t oshape[4];
  int32_t ondims = 4;
  int64_t n = ffc_model_predict(m, xb, xshape, 2, probs, BATCH * CLASSES, oshape, &ondims);
  if (n != BATCH * CLASSES || ondims != 2 || oshape[1] != CLASSES) {
    fprintf(stderr, "predict failed: n=%lld ndims=%d\n", (long long)n, ondims);
    return 1;
  }
  for (int r = 0; r < BATCH; ++r) {
    double rowsum = 0.0;
    for (int c = 0; c < CLASSES; ++c) rowsum += probs[r * CLASSES + c];
    if (rowsum < 0.99 || rowsum > 1.01) {
      fprintf(stderr, "softmax row %d sums to %f\n", r, rowsum);
      return 1;
    }
  }
  ffc_model_destroy(m);
  if (!(last < first)) {
    fprintf(stderr, "loss did not decrease: %f -> %f\n", first, last);
    return 1;
  }
  printf("C_MODEL_OK first=%.9g last=%.9g\n", first, last);
  return 0;
}

static int mha_leg(const char *device, int width, int heads, int seq, int batch, int layers,
                   int steps) {
  char config[256];
  snprintf(config, sizeof config, "{\"batch_size\": %d, \"device\": \"%s\"}", batch, device);
  ffc_model_t *m = ffc_model_create_json(config);
  if (!m) {
    fprintf(stderr, "ffc_model_create_json failed (mha)\n");
    return 1;
  }
  int64_t dims[3] = {batch, seq, width};
  int64_t t = ffc_model_input(m, dims, 3, "x");
  for (int l = 0; l < layers && t >= 0; ++l) t = ffc_model_mha(m, t, t, t, width, heads, "");
  int64_t out = t >= 0 ? ffc_model_dense(m, t, width, "none", "head") : -1;
  if (out < 0) {
    fprintf(stderr, "mha graph build failed\n");
    return 1;
  }
  if (ffc_model_compile(m, 0.01, "mean_squared_error") != 0) {
    fprintf(stderr, "mha compile failed\n");
    return 1;
  }
  int64_t n = (int64_t)batch * seq * width;
  double *xb = malloc(sizeof(double) * n);
  double *yb = malloc(sizeof(double) * n);
  lcg_state = 777u;
  for (int64_t i = 0; i < n; ++i) xb[i] = lcg_uniform();
  for (int64_t i = 0; i < n; ++i) yb[i] = lcg_uniform();
  double first = -1.0, last = -1.0;
  for (int step = 0; step < steps; ++step) {
    double loss = ffc_model_fit_step(m, xb, dims, 3, yb, dims, 3, 0);
    if (loss < 0.0) {
      fprintf(stderr, "mha fit_step failed at %d\n", step);
      return 1;
    }
    if (step == 0) first = loss;
    last = loss;
    printf("mha step %d loss %.9g\n", step, loss);
  }
  free(xb);
  free(yb);
  ffc_model_destroy(m);
  if (!(last < first)) {
    fprintf(stderr, "mha loss did not decrease: %f -> %f\n", first, last);
    return 1;
  }
  printf("C_MHA_OK first=%.9g last=%.9g\n", first, last);
  return 0;
}

int main(int argc, char **argv) {
  const char *device = argc > 1 ? argv[1] : "cuda";
  int width = argc > 2 ? atoi(argv[2]) : 64;
  int heads = argc > 3 ? atoi(argv[3]) : 4;
  int seq = argc > 4 ? atoi(argv[4]) : 16;
  int batch = argc > 5 ? atoi(argv[5]) : 4;
  int layers = argc > 6 ? atoi(argv[6]) : 1;
  int steps = argc > 7 ? atoi(argv[7]) : 3;
  int rc = mlp_leg(device);
  if (rc == 0) rc = mha_leg(device, width, heads, seq, batch, layers, steps);
  /* the launch counts, through the interpreter the C API started */
  fflush(stdout);
  if (Py_IsInitialized()) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyRun_SimpleString(
        "import json\n"
        "from flexflow_tpu_torch.ops.kernels import flash_attention as _fa\n"
        "print('FLASH_LAUNCHES ' + json.dumps(_fa.LAUNCHES), flush=True)\n");
    PyGILState_Release(st);
  }
  return rc;
}
