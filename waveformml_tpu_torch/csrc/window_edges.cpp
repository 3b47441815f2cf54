// Window-neighborhood edge construction over batch-sorted detector coordinates.
//
// Native equivalent of the reference's C kernel (ref:
// src/custom_functions/cffi.c:5-37 cffi_window_edges): for rows sorted by
// event id, emit symmetric edge pairs between rows of the same event whose
// (x, y) Chebyshev distance is < n, plus optional self loops.
//
// Improvements over the reference: a two-pass (count, then parallel fill)
// layout so the fill loop parallelizes with OpenMP across events and callers
// can size the output exactly, plus an upfront per-row offset table instead of
// a single running cursor.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Count edges per row (including self loop slot when requested).
// Returns the total number of edges.
int64_t window_edges_count(
    const int64_t n,          // exclusive Chebyshev distance bound
    const int64_t num_elem,
    const int64_t* x,
    const int64_t* y,
    const int64_t* b,
    const bool self_loop,
    int64_t* per_row_counts   // [num_elem] out
) {
    #pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < num_elem; i++) {
        int64_t count = self_loop ? 1 : 0;
        for (int64_t j = i + 1; j < num_elem && b[j] == b[i]; j++) {
            const int64_t dx = x[i] > x[j] ? x[i] - x[j] : x[j] - x[i];
            const int64_t dy = y[i] > y[j] ? y[i] - y[j] : y[j] - y[i];
            if (dx < n && dy < n) count += 2;  // symmetric pair
        }
        per_row_counts[i] = count;
    }
    int64_t total = 0;
    for (int64_t i = 0; i < num_elem; i++) total += per_row_counts[i];
    return total;
}

// Fill the edge arrays using precomputed per-row offsets (exclusive prefix
// sums of per_row_counts). Edge ordering per row matches the reference:
// optional self loop first, then (i, j), (j, i) pairs in ascending j.
void window_edges_fill(
    const int64_t n,
    const int64_t num_elem,
    const int64_t* x,
    const int64_t* y,
    const int64_t* b,
    const bool self_loop,
    const int64_t* offsets,   // [num_elem]
    int64_t* edges1,
    int64_t* edges2
) {
    #pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < num_elem; i++) {
        int64_t k = offsets[i];
        if (self_loop) {
            edges1[k] = i;
            edges2[k] = i;
            k++;
        }
        for (int64_t j = i + 1; j < num_elem && b[j] == b[i]; j++) {
            const int64_t dx = x[i] > x[j] ? x[i] - x[j] : x[j] - x[i];
            const int64_t dy = y[i] > y[j] ? y[i] - y[j] : y[j] - y[i];
            if (dx < n && dy < n) {
                edges1[k] = i;
                edges2[k] = j;
                k++;
                edges1[k] = j;
                edges2[k] = i;
                k++;
            }
        }
    }
}

// kNN over 2D positions within each event (batch-sorted rows): for each row,
// the k nearest same-event rows by squared euclidean distance. Writes
// (src=neighbor, dst=row) pairs; rows with fewer than k same-event peers get
// fewer edges. Returns the number of edges written.
int64_t knn_edges(
    const int64_t k,
    const int64_t num_elem,
    const double* px,
    const double* py,
    const int64_t* b,
    const bool loop,
    int64_t* edges1,
    int64_t* edges2
) {
    // event boundaries
    std::vector<int64_t> starts;
    starts.push_back(0);
    for (int64_t i = 1; i < num_elem; i++)
        if (b[i] != b[i - 1]) starts.push_back(i);
    starts.push_back(num_elem);
    const int64_t n_events = (int64_t)starts.size() - 1;

    std::vector<int64_t> counts(num_elem, 0);
    std::vector<std::vector<int64_t>> neigh(num_elem);

    #pragma omp parallel for schedule(dynamic, 8)
    for (int64_t e = 0; e < n_events; e++) {
        const int64_t lo = starts[e], hi = starts[e + 1];
        for (int64_t i = lo; i < hi; i++) {
            // collect squared distances to same-event rows
            std::vector<std::pair<double, int64_t>> d;
            d.reserve(hi - lo);
            for (int64_t j = lo; j < hi; j++) {
                if (j == i && !loop) continue;
                const double dx = px[i] - px[j];
                const double dy = py[i] - py[j];
                d.emplace_back(dx * dx + dy * dy, j);
            }
            const int64_t kk = (int64_t)d.size() < k ? (int64_t)d.size() : k;
            std::partial_sort(d.begin(), d.begin() + kk, d.end());
            neigh[i].reserve(kk);
            for (int64_t m = 0; m < kk; m++) neigh[i].push_back(d[m].second);
            counts[i] = kk;
        }
    }
    int64_t idx = 0;
    for (int64_t i = 0; i < num_elem; i++) {
        for (int64_t m = 0; m < counts[i]; m++) {
            edges1[idx] = neigh[i][m];  // source = neighbor
            edges2[idx] = i;            // target = row
            idx++;
        }
    }
    return idx;
}

}  // extern "C"
