/* seamlessclone_tpu_torch.h: C ABI of the PyTorch/CUDA seamless-clone engine.
 *
 * The same five entry points, names and signatures as the JAX package's
 * seamlessclone_tpu.h, so a C caller switches engines by linking the other
 * library; both are the counterpart of the reference's extern-C surface
 * (seamlessClone-CUDA/seamlessclone_cuda.h:6-62). Build the library with
 *
 *     python -c "from seamlesscloneoptimization_tpu_torch import capi_host as h; print(h.build_library())"
 *
 * and link the path it prints. The library embeds a CPython interpreter
 * that hosts seamlesscloneoptimization_tpu_torch.capi_host: before the first
 * call, set SC_TPU_PYTHONPATH to the repo root and the directories holding
 * torch and numpy (colon separated; a virtual environment's site-packages
 * are not on the embedded interpreter's path otherwise).
 *
 * Thread-safety: every entry point takes the GIL; calls from any thread
 * serialize, as in the reference's single-stream design.
 */
#ifndef SEAMLESSCLONE_TPU_TORCH_H_
#define SEAMLESSCLONE_TPU_TORCH_H_

#ifdef __cplusplus
extern "C" {
#endif

/* Create an engine instance.
 *   device_id:    index of the CUDA device; -1 = the default CUDA device.
 *   config_json:  JSON object of CloneConfig fields, e.g.
 *                 "{\"solver\": \"dst_gemm\", \"flags\": 1}";
 *                 {"platform": "cpu"} runs the plain PyTorch path on the CPU.
 * Returns an opaque handle, or NULL (see sc_tpu_last_error): without a
 * CUDA card and without {"platform": "cpu"}, creation fails. */
void* sc_tpu_create_instance(int device_id, const char* config_json);

/* Run one clone: paste `face` (fh x fw x 3, interleaved BGR uint8) into
 * `body` (bh x bw x 3) under `mask` (mh x mw, may be NULL = full), centered
 * at (cx, cy). The blended destination is written to `out` (bh*bw*3 bytes)
 * before return. `sync` nonzero additionally waits for the device.
 * Returns 0 on success, -1 on error. */
int sc_tpu_run(void* inst, const unsigned char* face, int fh, int fw,
               const unsigned char* body, int bh, int bw,
               const unsigned char* mask, int mh, int mw,
               int cx, int cy, unsigned char* out, int sync);

/* Block until all work dispatched on this instance has completed. */
int sc_tpu_sync(void* inst);

/* Destroy the instance and release its cached device tensors. */
void sc_tpu_destroy(void* inst);

/* Message of the most recent failure on this thread. */
const char* sc_tpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* SEAMLESSCLONE_TPU_TORCH_H_ */
