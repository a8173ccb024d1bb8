/* A plain C program that runs libseamlessclone_tpu_torch.
 *
 *   test_capi FACE FH FW BODY BH BW MASK CX CY DEVICE_ID CONFIG_JSON OUT1 OUT2
 *
 * FACE, BODY and MASK are raw interleaved BGR uint8 files (fh x fw x 3,
 * bh x bw x 3, fh x fw; MASK "-" passes NULL, a full mask). The program
 * follows the reference CLI's flow (seamlessClone_main.cu:69-94): it creates
 * an instance on DEVICE_ID (-1: the default device) with CONFIG_JSON, runs
 * the clone once on the main thread and once more on the same instance from
 * another pthread (the embedded interpreter must have released the GIL
 * after its initialization, or that run waits forever), calls
 * sc_tpu_sync, writes the two outputs (bh x bw x 3 bytes each) to OUT1 and
 * OUT2, destroys the instance and prints "C ABI runs done". The caller
 * compares the outputs. Any failure prints sc_tpu_last_error() and exits 1.
 *
 * Build: seamlesscloneoptimization_tpu_torch.capi_host.build_test_program().
 */
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "seamlessclone_tpu_torch.h"

struct run_args {
  void* inst;
  const unsigned char *face, *body, *mask;
  unsigned char* out;
  int fh, fw, bh, bw, cx, cy, rc;
  double ms;
  char err[1024];
};

static double now_ms(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e3 + t.tv_nsec / 1e6;
}

static void* run_clone(void* p) {
  struct run_args* a = (struct run_args*)p;
  double t0 = now_ms();
  a->rc = sc_tpu_run(a->inst, a->face, a->fh, a->fw, a->body, a->bh, a->bw, a->mask,
                     a->fh, a->fw, a->cx, a->cy, a->out, 1);
  a->ms = now_ms() - t0;
  /* the last error is per thread: keep this thread's */
  if (a->rc != 0) snprintf(a->err, sizeof a->err, "%s", sc_tpu_last_error());
  return NULL;
}

static unsigned char* read_raw(const char* path, size_t n) {
  FILE* f = fopen(path, "rb");
  unsigned char* buf = malloc(n ? n : 1);
  if (!f || !buf || fread(buf, 1, n, f) != n) {
    fprintf(stderr, "cannot read %zu bytes from %s\n", n, path);
    exit(1);
  }
  fclose(f);
  return buf;
}

static void write_raw(const char* path, const unsigned char* buf, size_t n) {
  FILE* f = fopen(path, "wb");
  if (!f || fwrite(buf, 1, n, f) != n || fclose(f) != 0) {
    fprintf(stderr, "cannot write %s\n", path);
    exit(1);
  }
}

int main(int argc, char** argv) {
  if (argc != 14) {
    fprintf(stderr, "usage: %s FACE FH FW BODY BH BW MASK CX CY DEVICE_ID CONFIG_JSON "
                    "OUT1 OUT2\n", argv[0]);
    return 2;
  }
  const int fh = atoi(argv[2]), fw = atoi(argv[3]);
  const int bh = atoi(argv[5]), bw = atoi(argv[6]);
  const size_t face_n = (size_t)fh * fw * 3, body_n = (size_t)bh * bw * 3;
  unsigned char* face = read_raw(argv[1], face_n);
  unsigned char* body = read_raw(argv[4], body_n);
  unsigned char* mask = strcmp(argv[7], "-") ? read_raw(argv[7], (size_t)fh * fw) : NULL;
  unsigned char* out1 = malloc(body_n);
  unsigned char* out2 = malloc(body_n);

  double t0 = now_ms();
  void* inst = sc_tpu_create_instance(atoi(argv[10]), argv[11]);
  if (!inst) {
    fprintf(stderr, "create_instance failed: %s\n", sc_tpu_last_error());
    return 1;
  }
  printf("create_instance: %.1f ms\n", now_ms() - t0);

  struct run_args a = {inst, face, body, mask, out1, fh, fw, bh, bw,
                       atoi(argv[8]), atoi(argv[9]), -1, 0.0, ""};
  run_clone(&a);
  if (a.rc != 0) {
    fprintf(stderr, "run failed: %s\n", a.err);
    return 1;
  }
  if (sc_tpu_sync(inst) != 0) {
    fprintf(stderr, "sync failed: %s\n", sc_tpu_last_error());
    return 1;
  }
  printf("run on the main thread: %.3f ms\n", a.ms);

  struct run_args b = a;
  b.out = out2;
  b.rc = -1;
  pthread_t th;
  if (pthread_create(&th, NULL, run_clone, &b) != 0 || pthread_join(th, NULL) != 0) {
    fprintf(stderr, "cannot run a second thread\n");
    return 1;
  }
  if (b.rc != 0) {
    fprintf(stderr, "run on another thread failed: %s\n", b.err);
    return 1;
  }
  printf("run on another thread: %.3f ms\n", b.ms);
  sc_tpu_destroy(inst);

  write_raw(argv[12], out1, body_n);
  write_raw(argv[13], out2, body_n);
  printf("C ABI runs done\n");
  return 0;
}
