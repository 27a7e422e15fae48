// Native query engine for the binary feature store.
//
// Role: the host-side hot loop of the feature_database replacement —
// response-ranked, spatially-windowed keypoint selection over stores with
// millions of rows (the reference delegates this to Postgres indexes +
// ORDER BY response DESC LIMIT 2^18-1; feature_database/src/
// keypointdb.rs:67-90). Python owns the mmap'd column arrays (zero-copy
// np.memmap); this module provides the scan kernels via ctypes.
//
// A copy of the JAX package's store/native/store_query.cc. Built at first
// use by store/native/__init__.py (g++ -O3 -shared -fPIC) into build/store/
// at the repository root.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Scan `order` (a response-descending permutation of row indices) and
// collect up to `limit` rows whose (x, y) fall inside the window and
// whose lod matches. Returns the number of rows written to `out`.
// Early-exits at `limit`, so typical queries touch far fewer rows than n.
int64_t query_window(const float* x, const float* y, const int32_t* lod,
                     const int32_t* order, int64_t n,
                     float x0, float x1, float y0, float y1,
                     int32_t lod_sel, int64_t limit, int32_t* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n && m < limit; ++i) {
    const int32_t r = order[i];
    if (lod[r] != lod_sel) continue;
    const float xr = x[r];
    const float yr = y[r];
    if (xr < x0 || xr > x1 || yr < y0 || yr > y1) continue;
    out[m++] = r;
  }
  return m;
}

// Same, but filtered by lod only (read_keypoints_from_lod semantics,
// keypointdb.rs:50-65).
int64_t query_lod(const int32_t* lod, const int32_t* order, int64_t n,
                  int32_t lod_sel, int64_t limit, int32_t* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n && m < limit; ++i) {
    const int32_t r = order[i];
    if (lod[r] == lod_sel) out[m++] = r;
  }
  return m;
}

// Filtered by image id (read_keypoints_from_image_id, keypointdb.rs:38-48).
int64_t query_image(const int32_t* image_id, const int32_t* order,
                    int64_t n, int32_t image_sel, int64_t limit,
                    int32_t* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n && m < limit; ++i) {
    const int32_t r = order[i];
    if (image_id[r] == image_sel) out[m++] = r;
  }
  return m;
}

// Response-descending argsort (stable) — builds the `order` permutation
// at store-write time.
void argsort_response_desc(const float* response, int64_t n,
                           int32_t* order) {
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
  std::stable_sort(order, order + n, [&](int32_t a, int32_t b) {
    return response[a] > response[b];
  });
}

// Gather packed descriptor rows (desc_bytes each) for a set of row
// indices — feeds the device-upload path without intermediate Python.
void gather_descriptors(const uint8_t* desc, int64_t desc_bytes,
                        const int32_t* rows, int64_t m, uint8_t* out) {
  for (int64_t i = 0; i < m; ++i) {
    std::memcpy(out + i * desc_bytes, desc + int64_t(rows[i]) * desc_bytes,
                desc_bytes);
  }
}

}  // extern "C"
