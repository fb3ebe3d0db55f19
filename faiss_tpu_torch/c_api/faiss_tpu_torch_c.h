/* faiss_tpu_torch C API: the functions of faiss_tpu's c_api/faiss_tpu_c.h
 * over the PyTorch port (the reference's c_api/ Index_c.h,
 * index_factory_c.h, index_io_c.h: opaque pointers, int error codes, a last
 * error message). The implementation embeds Python and the faiss_tpu_torch_torch
 * package; C callers never see Python objects. Indexes live on the device
 * given to init ("cuda" for the card, "cpu").
 *
 * Usage:
 *   faiss_tpu_torch_init(NULL, "cuda");
 *   FaissTpuTorchIndex* idx = NULL;
 *   faiss_tpu_torch_index_factory(&idx, 64, "IVF64,PQ8", FAISS_TPU_TORCH_METRIC_L2);
 *   faiss_tpu_torch_Index_train(idx, n, xt);
 *   faiss_tpu_torch_Index_add(idx, n, xb);
 *   faiss_tpu_torch_Index_search(idx, nq, xq, 10, D, I);
 *   faiss_tpu_torch_Index_free(idx);
 *
 * All functions return 0 on success, -1 on error (message via
 * faiss_tpu_torch_get_last_error). Calls serialize on the embedded
 * interpreter's GIL.
 */

#ifndef FAISS_TPU_TORCH_C_H
#define FAISS_TPU_TORCH_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct FaissTpuTorchIndex FaissTpuTorchIndex; /* opaque */
typedef int64_t faiss_tpu_torch_idx_t;

enum {
    FAISS_TPU_TORCH_METRIC_INNER_PRODUCT = 0,
    FAISS_TPU_TORCH_METRIC_L2 = 1,
};

/* interpreter lifecycle; repo_path may be NULL (installed package);
 * device: where the indexes live, "cuda" (the card) or "cpu" */
int faiss_tpu_torch_init(const char* repo_path, const char* device);
void faiss_tpu_torch_shutdown(void);
const char* faiss_tpu_torch_get_last_error(void);

/* construction */
int faiss_tpu_torch_index_factory(
        FaissTpuTorchIndex** out,
        int d,
        const char* description,
        int metric);
void faiss_tpu_torch_Index_free(FaissTpuTorchIndex* index);

/* properties */
faiss_tpu_torch_idx_t faiss_tpu_torch_Index_ntotal(const FaissTpuTorchIndex* index);
int faiss_tpu_torch_Index_d(const FaissTpuTorchIndex* index);
int faiss_tpu_torch_Index_is_trained(const FaissTpuTorchIndex* index);

/* core ops (Index_c.h parity) */
int faiss_tpu_torch_Index_train(
        FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x);
int faiss_tpu_torch_Index_add(
        FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x);
int faiss_tpu_torch_Index_add_with_ids(
        FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x,
        const faiss_tpu_torch_idx_t* ids);
int faiss_tpu_torch_Index_search(
        const FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x,
        faiss_tpu_torch_idx_t k,
        float* distances,
        faiss_tpu_torch_idx_t* labels);
int faiss_tpu_torch_Index_reset(FaissTpuTorchIndex* index);
int faiss_tpu_torch_Index_reconstruct(
        const FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t key,
        float* recons);

/* runtime parameters (ParameterSpace::set_index_parameter analogue) */
int faiss_tpu_torch_Index_set_parameter(
        FaissTpuTorchIndex* index,
        const char* name,
        double value);

/* io (index_io_c.h parity) */
int faiss_tpu_torch_write_index(const FaissTpuTorchIndex* index, const char* fname);
int faiss_tpu_torch_read_index(
        FaissTpuTorchIndex** out,
        const char* fname,
        int io_flags);

#ifdef __cplusplus
}
#endif

#endif /* FAISS_TPU_TORCH_C_H */
