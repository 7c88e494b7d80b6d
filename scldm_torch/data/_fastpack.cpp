// Single-pass CSR -> (dense counts, packed expressed subsets, library sizes)
// (counterpart of scldm_tpu/data/_fastpack.cpp).
//
// The native hot loop of the input pipeline: one traversal of the nonzeros
// fills the left-packed gene / count subset buffers, the per-cell library
// sizes and, unless `counts` is null (the lean wire batch), the dense count
// block. Built with g++ on first use by scldm_torch/data/fastpath.py and
// called through ctypes, which releases the GIL for the call, so packing
// overlaps the train step. The library size is summed in double in nonzero
// order and rounded once, as numpy's bincount does, so the bits equal the
// numpy path's on any data.

#include <cstdint>

extern "C" {

void fastpack_expressed(
    const float* data,         // (nnz,)
    const int64_t* indices,    // (nnz,) column ids
    const int64_t* indptr,     // (n+1,) local row offsets
    const int64_t* gene_row,   // (g,) encoded gene-token ids
    float* counts,             // (n, g) zero-initialized, or null: no dense block
    int32_t* genes_sub,        // (n, seq_len) zero-initialized (mask idx 0)
    float* counts_sub,         // (n, seq_len) zero-initialized
    float* library,            // (n,)
    int64_t n,
    int64_t g,
    int64_t seq_len)
{
    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo = indptr[i];
        const int64_t hi = indptr[i + 1];
        int32_t* gsub_row = genes_sub + i * seq_len;
        float* csub_row = counts_sub + i * seq_len;
        double lib = 0.0;
        for (int64_t k = lo; k < hi; ++k) {
            const int64_t col = indices[k];
            const float v = data[k];
            const int64_t pos = k - lo;
            gsub_row[pos] = static_cast<int32_t>(gene_row[col]);
            csub_row[pos] = v;
            lib += static_cast<double>(v);
        }
        if (counts != nullptr) {
            float* counts_row = counts + i * g;
            for (int64_t k = lo; k < hi; ++k) counts_row[indices[k]] = data[k];
        }
        library[i] = static_cast<float>(lib);
    }
}

}  // extern "C"
