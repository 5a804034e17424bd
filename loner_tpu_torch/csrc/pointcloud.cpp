// loner_tpu_torch host library: the per-sweep point-cloud front end.
//
// The port's own copy of the JAX package's native/pointcloud.cpp (cloud
// extraction for ICP, voxel downsampling, the harvester box filter, the
// range filter and the sky-segmentation occupancy image), bound with ctypes
// by loner_tpu_torch/runtime/native.py, which also holds the numpy path each
// function must equal. Two changes make the two paths compute the same
// numbers: voxel_downsample returns its voxels in ascending (x, y, z) key
// order (np.unique's), and spherical_occupancy bins in double precision.
// Built with g++ -O3 -fPIC -shared -std=c++17 -ffp-contract=off at first use.

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

extern "C" {

// Uniform-stride downsample of the first `keep_fraction` of a time-sorted
// scan into exactly n_out points (the tail padded with zeros and valid = 0).
void extract_cloud(const float* points, const float* timestamps, const uint8_t* valid, int64_t n,
                   float keep_fraction, int64_t n_out, float* out_points, uint8_t* out_valid) {
    float tmin = INFINITY, tmax = -INFINITY;
    for (int64_t i = 0; i < n; ++i) {
        if (valid[i]) {
            if (timestamps[i] < tmin) tmin = timestamps[i];
            if (timestamps[i] > tmax) tmax = timestamps[i];
        }
    }
    const float tcut = tmin + keep_fraction * (tmax - tmin);

    std::vector<int64_t> idx;
    idx.reserve(n);
    for (int64_t i = 0; i < n; ++i)
        if (valid[i] && timestamps[i] <= tcut) idx.push_back(i);

    const int64_t m = (int64_t)idx.size();
    if (m <= n_out) {
        for (int64_t j = 0; j < m; ++j) {
            std::memcpy(out_points + 3 * j, points + 3 * idx[j], 3 * sizeof(float));
            out_valid[j] = 1;
        }
        for (int64_t j = m; j < n_out; ++j) {
            out_points[3 * j] = out_points[3 * j + 1] = out_points[3 * j + 2] = 0.f;
            out_valid[j] = 0;
        }
    } else {
        const double step = (double)(m - 1) / (double)(n_out > 1 ? n_out - 1 : 1);
        for (int64_t j = 0; j < n_out; ++j) {
            const int64_t src = idx[(int64_t)std::llround(j * step)];
            std::memcpy(out_points + 3 * j, points + 3 * src, 3 * sizeof(float));
            out_valid[j] = 1;
        }
    }
}

// Voxel-grid downsample: the mean of the points of each voxel, the voxels in
// ascending (x, y, z) key order. Returns the number of points written
// (<= max_out).
int64_t voxel_downsample(const float* points, int64_t n, float voxel_size, float* out_points,
                         int64_t max_out) {
    struct Acc { double x = 0, y = 0, z = 0; int64_t c = 0; };
    std::map<std::array<int64_t, 3>, Acc> cells;
    const double inv = 1.0 / (double)voxel_size;
    for (int64_t i = 0; i < n; ++i) {
        const std::array<int64_t, 3> key = {(int64_t)std::floor((double)points[3 * i] * inv),
                                            (int64_t)std::floor((double)points[3 * i + 1] * inv),
                                            (int64_t)std::floor((double)points[3 * i + 2] * inv)};
        Acc& a = cells[key];
        a.x += points[3 * i];
        a.y += points[3 * i + 1];
        a.z += points[3 * i + 2];
        a.c += 1;
    }
    int64_t j = 0;
    for (const auto& kv : cells) {
        if (j >= max_out) break;
        out_points[3 * j] = (float)(kv.second.x / (double)kv.second.c);
        out_points[3 * j + 1] = (float)(kv.second.y / (double)kv.second.c);
        out_points[3 * j + 2] = (float)(kv.second.z / (double)kv.second.c);
        ++j;
    }
    return j;
}

// Axis-aligned box filter in the sensor frame: invalidates points inside the
// box of size (sx, sy, sz) centred at (cx, cy, cz), in place on the mask.
void box_filter(const float* points, uint8_t* valid, int64_t n, float cx, float cy, float cz, float sx, float sy,
                float sz) {
    const float hx = sx * 0.5f, hy = sy * 0.5f, hz = sz * 0.5f;
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        const float x = points[3 * i] - cx;
        const float y = points[3 * i + 1] - cy;
        const float z = points[3 * i + 2] - cz;
        if (std::fabs(x) <= hx && std::fabs(y) <= hy && std::fabs(z) <= hz) valid[i] = 0;
    }
}

// Range filter: invalidates points whose range is outside [min_range, max_range].
void range_filter(const float* distances, uint8_t* valid, int64_t n, float min_range, float max_range) {
    for (int64_t i = 0; i < n; ++i)
        if (valid[i] && (distances[i] < min_range || distances[i] > max_range)) valid[i] = 0;
}

// Spherical-projection occupancy image (n_el, n_az) for sky segmentation:
// marks the cells hit by valid returns; row 0 is the highest elevation.
void spherical_occupancy(const float* dirs, const uint8_t* valid, int64_t n, int32_t n_az, int32_t n_el,
                         float el_lo, float el_hi, uint8_t* out_img) {
    std::memset(out_img, 0, (size_t)n_az * n_el);
    const double lo = el_lo, hi = el_hi, pi = 3.141592653589793, two_pi = 2.0 * pi;
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        const double x = dirs[3 * i], y = dirs[3 * i + 1], z = dirs[3 * i + 2];
        const double az = std::atan2(y, x);
        const double el = std::asin(z < -1.0 ? -1.0 : (z > 1.0 ? 1.0 : z));  // NaN stays NaN, as np.clip
        if (!(el >= lo && el <= hi)) continue;
        const int64_t col = (int64_t)((az + pi) / two_pi * n_az) % n_az;
        int64_t row = (int64_t)((hi - el) / (hi - lo) * n_el);
        if (row < 0) row = 0;
        if (row >= n_el) row = n_el - 1;
        out_img[row * n_az + col] = 1;
    }
}

}  // extern "C"
