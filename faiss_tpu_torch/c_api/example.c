/* C API example (the reference's c_api example_c): build an IVF index
 * from C on a device, search it, and read it back from a file.
 *
 *   example_c REPO DEVICE INDEX_FILE
 *
 * REPO is put first on the embedded interpreter's path (may be "-" for
 * none), DEVICE is "cuda" or "cpu", INDEX_FILE is where the index is
 * written and read. Prints "C API EXAMPLE: OK" and exits 0 when every
 * check holds. */

#include "faiss_tpu_torch_c.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define CHECK(call)                                                   \
    do {                                                              \
        if ((call) != 0) {                                            \
            fprintf(stderr,                                           \
                    "FAIL %s: %s\n",                                  \
                    #call,                                            \
                    faiss_tpu_torch_get_last_error());                      \
            return 1;                                                 \
        }                                                             \
    } while (0)

int main(int argc, char** argv) {
    if (argc != 4) {
        fprintf(stderr, "usage: %s REPO DEVICE INDEX_FILE\n", argv[0]);
        return 1;
    }
    const char* repo = strcmp(argv[1], "-") ? argv[1] : NULL;
    const char* device = argv[2];
    const char* fname = argv[3];
    int d = 32;
    long long nb = 4000, nq = 10, k = 5;

    CHECK(faiss_tpu_torch_init(repo, device));

    float* xb = malloc(nb * d * sizeof(float));
    float* xq = malloc(nq * d * sizeof(float));
    srand(123);
    for (long long i = 0; i < nb * d; i++) {
        xb[i] = (float)rand() / RAND_MAX;
    }
    for (long long i = 0; i < nq * d; i++) {
        xq[i] = xb[i]; /* queries = first db rows: NN must be identity */
    }

    FaissTpuTorchIndex* index = NULL;
    CHECK(faiss_tpu_torch_index_factory(
            &index, d, "IVF16,Flat", FAISS_TPU_TORCH_METRIC_L2));
    CHECK(faiss_tpu_torch_Index_train(index, nb, xb));
    CHECK(faiss_tpu_torch_Index_add(index, nb, xb));
    printf("ntotal=%lld trained=%d\n",
           (long long)faiss_tpu_torch_Index_ntotal(index),
           faiss_tpu_torch_Index_is_trained(index));

    CHECK(faiss_tpu_torch_Index_set_parameter(index, "nprobe", 16));

    float* D = malloc(nq * k * sizeof(float));
    faiss_tpu_torch_idx_t* I = malloc(nq * k * sizeof(faiss_tpu_torch_idx_t));
    CHECK(faiss_tpu_torch_Index_search(index, nq, xq, k, D, I));
    int ok = 1;
    for (long long q = 0; q < nq; q++) {
        if (I[q * k] != q || D[q * k] > 1e-4f) {
            ok = 0;
        }
        printf("q%lld -> id %lld dist %.4f\n",
               q,
               (long long)I[q * k],
               D[q * k]);
    }

    /* io round trip */
    CHECK(faiss_tpu_torch_write_index(index, fname));
    FaissTpuTorchIndex* loaded = NULL;
    CHECK(faiss_tpu_torch_read_index(&loaded, fname, 0));
    printf("reloaded ntotal=%lld\n",
           (long long)faiss_tpu_torch_Index_ntotal(loaded));
    float* D2 = malloc(nq * k * sizeof(float));
    faiss_tpu_torch_idx_t* I2 = malloc(nq * k * sizeof(faiss_tpu_torch_idx_t));
    CHECK(faiss_tpu_torch_Index_set_parameter(loaded, "nprobe", 16));
    CHECK(faiss_tpu_torch_Index_search(loaded, nq, xq, k, D2, I2));
    for (long long i = 0; i < nq * k; i++) {
        if (I[i] != I2[i]) {
            ok = 0;
        }
    }

    /* error path: mismatched description must set an error */
    FaissTpuTorchIndex* bad = NULL;
    if (faiss_tpu_torch_index_factory(&bad, d, "NotAnIndex", 1) == 0) {
        printf("expected factory error\n");
        ok = 0;
    } else {
        printf("factory error correctly reported: %.60s\n",
               faiss_tpu_torch_get_last_error());
    }

    faiss_tpu_torch_Index_free(index);
    faiss_tpu_torch_Index_free(loaded);
    printf("device %s\n", device);
    printf(ok ? "C API EXAMPLE: OK\n" : "C API EXAMPLE: FAILED\n");
    return ok ? 0 : 2;
}
