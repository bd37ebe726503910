// Host-side dynamic voxelizer (C++), the production input-pipeline path.
//
// Native analog of the reference's numba kernel
// (seg3d/core/voxel/voxel_generator.py:98-153) with identical semantics:
// per-axis floor binning, strict [0, grid) bounds, zyx coords emitted in
// ascending linearized-key order (the device pipeline's planar submanifold
// conv relies on sorted slot order), out-of-range points get id -1.
//
// Uses an open-addressing hash table over linearized keys instead of the
// reference's dense grid canvas (1440*1440*64 int32 = 530 MB per worker);
// the table is ~2x the voxel count.
//
// A copy of openseg3d_tpu/native/voxelizer.cpp with one fix, which moves no
// result without a capacity (the only way either package calls it): with
// max_voxels below the number of distinct voxels, the original inserts the
// keys past the capacity into a table sized for max_voxels, so that a later
// point of such a voxel reads an id past the capacity (an out-of-bounds
// read in the renumbering) and the table can fill up. Here the table holds
// every point's key and an id past the capacity drops the point.
//
// Also provides the majority-vote voxel labeler
// (waymo_dataset.py:213-246 semantics: ignore labels participate, ties go to
// the smallest label id).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct HashTable {
    // open addressing, linear probing; key = linear voxel id, val = voxel idx
    std::vector<int64_t> keys;
    std::vector<int32_t> vals;
    size_t mask;

    explicit HashTable(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        keys.assign(cap, -1);
        vals.assign(cap, -1);
        mask = cap - 1;
    }

    // returns existing idx or -1 if inserted with new_val
    int32_t get_or_insert(int64_t key, int32_t new_val) {
        size_t h = static_cast<size_t>(key * 0x9E3779B97F4A7C15ULL) & mask;
        for (;;) {
            if (keys[h] == key) return vals[h];
            if (keys[h] == -1) {
                keys[h] = key;
                vals[h] = new_val;
                return -1;
            }
            h = (h + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// points [n, dim] row-major (x, y, z, ...) -> point_voxel_ids [n],
// coords_out [max_voxels, 3] zyx. Returns the number of voxels created
// (clamped to max_voxels; overflow points get id -1).
int32_t voxelize(const float* points, int64_t n, int32_t dim,
                 const float* voxel_size, const float* range_min,
                 int32_t gx, int32_t gy, int32_t gz,
                 int32_t* point_voxel_ids, int32_t* coords_out,
                 int32_t max_voxels) {
    const float inv_vx = 1.0f / voxel_size[0];
    const float inv_vy = 1.0f / voxel_size[1];
    const float inv_vz = 1.0f / voxel_size[2];
    HashTable table(static_cast<size_t>(std::max<int64_t>(max_voxels, n)));
    int32_t num_voxels = 0;

    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * dim;
        const int64_t cx = static_cast<int64_t>(std::floor((p[0] - range_min[0]) * inv_vx));
        const int64_t cy = static_cast<int64_t>(std::floor((p[1] - range_min[1]) * inv_vy));
        const int64_t cz = static_cast<int64_t>(std::floor((p[2] - range_min[2]) * inv_vz));
        if (cx < 0 || cx >= gx || cy < 0 || cy >= gy || cz < 0 || cz >= gz) {
            point_voxel_ids[i] = -1;
            continue;
        }
        const int64_t key = (cz * gy + cy) * gx + cx;
        int32_t idx = table.get_or_insert(key, num_voxels);
        if (idx >= max_voxels) {      // a voxel past the capacity
            point_voxel_ids[i] = -1;
            continue;
        }
        if (idx == -1) {
            if (num_voxels >= max_voxels) {
                point_voxel_ids[i] = -1;  // capacity overflow: drop
                continue;
            }
            idx = num_voxels++;
            coords_out[idx * 3 + 0] = static_cast<int32_t>(cz);
            coords_out[idx * 3 + 1] = static_cast<int32_t>(cy);
            coords_out[idx * 3 + 2] = static_cast<int32_t>(cx);
        }
        point_voxel_ids[i] = idx;
    }

    // Renumber voxels into ascending linearized-key order. Downstream device
    // code relies on key-sorted slot order (planar submanifold conv,
    // ops/sparse_conv.py); the reference's first-seen order is an artifact of
    // its canvas fill and is semantically a relabeling (SURVEY.md §7.3).
    {
        std::vector<int32_t> perm(static_cast<size_t>(num_voxels));
        for (int32_t v = 0; v < num_voxels; ++v) perm[v] = v;
        const int32_t* co = coords_out;
        const int64_t lgy = gy, lgx = gx;
        std::sort(perm.begin(), perm.end(), [co, lgy, lgx](int32_t a, int32_t b) {
            const int64_t ka = (static_cast<int64_t>(co[a * 3]) * lgy + co[a * 3 + 1]) * lgx + co[a * 3 + 2];
            const int64_t kb = (static_cast<int64_t>(co[b * 3]) * lgy + co[b * 3 + 1]) * lgx + co[b * 3 + 2];
            return ka < kb;
        });
        std::vector<int32_t> old2new(static_cast<size_t>(num_voxels));
        std::vector<int32_t> sorted_coords(static_cast<size_t>(num_voxels) * 3);
        for (int32_t r = 0; r < num_voxels; ++r) {
            const int32_t old = perm[r];
            old2new[old] = r;
            std::memcpy(&sorted_coords[static_cast<size_t>(r) * 3],
                        &coords_out[static_cast<size_t>(old) * 3],
                        3 * sizeof(int32_t));
        }
        std::memcpy(coords_out, sorted_coords.data(),
                    sorted_coords.size() * sizeof(int32_t));
        for (int64_t i = 0; i < n; ++i) {
            if (point_voxel_ids[i] >= 0)
                point_voxel_ids[i] = old2new[point_voxel_ids[i]];
        }
    }
    return num_voxels;
}

// Majority label per voxel; ids [n] (-1 skipped), labels [n] in [0, 256),
// out [num_voxels] prefilled by caller with ignore_index.
void majority_labels(const int32_t* ids, const int64_t* labels, int64_t n,
                     int32_t num_voxels, int32_t ignore_index, int32_t* out) {
    std::vector<uint16_t> counter(static_cast<size_t>(num_voxels) * 256, 0);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t v = ids[i];
        if (v < 0 || v >= num_voxels) continue;
        const int64_t l = labels[i];
        if (l < 0 || l > 255) continue;
        counter[static_cast<size_t>(v) * 256 + l]++;
    }
    for (int32_t v = 0; v < num_voxels; ++v) {
        const uint16_t* c = counter.data() + static_cast<size_t>(v) * 256;
        uint16_t best = 0;
        int32_t best_l = ignore_index;
        for (int32_t l = 0; l < 256; ++l) {
            if (c[l] > best) { best = c[l]; best_l = l; }
        }
        if (best > 0) out[v] = best_l;
    }
}

}  // extern "C"
