// Host-side graph construction for the port's data pipeline.
//
// The two O(N^2) functions of the loader (data/preprocessing.py): the
// pocket box filter and the inter/intra radius graph with its optional
// BFS pruning, plus the stable counting argsort of bounded ids used when
// edges are collated. Results equal the numpy plain versions
// (preprocessing.make_box_numpy / generate_edges_numpy) element for
// element: the same strict `< r` and `> 1e-7` comparisons and the same
// row-major edge order, the inter-molecular block first, then the
// intra block unfiltered by molecule. Also the host half of the v3 wire
// format (data/wire.py): the eligibility check of a symmetric edge list
// and its sender < receiver half. native/build.py compiles this file
// with g++ at first use and binds it with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Keep receptor atoms within `radius` of ANY ligand atom.
// keep[j] is set to 1 for surviving receptor atoms. Returns kept count.
int pvs_box_filter(const double* lig_xyz, int n_lig,
                   const double* rec_xyz, int n_rec,
                   double radius, uint8_t* keep) {
    const double r2 = radius * radius;
    // Ligand bounding box expanded by radius: a 6-compare reject
    // eliminates the bulk of the receptor before the O(n_lig) scan.
    double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
    for (int i = 0; i < n_lig; ++i) {
        for (int a = 0; a < 3; ++a) {
            const double v = lig_xyz[3 * i + a];
            if (v < mn[a]) mn[a] = v;
            if (v > mx[a]) mx[a] = v;
        }
    }
    for (int a = 0; a < 3; ++a) {
        mn[a] -= radius;
        mx[a] += radius;
    }
    int kept = 0;
    for (int j = 0; j < n_rec; ++j) {
        const double rx = rec_xyz[3 * j];
        const double ry = rec_xyz[3 * j + 1];
        const double rz = rec_xyz[3 * j + 2];
        uint8_t hit = 0;
        if (rx >= mn[0] && rx <= mx[0] && ry >= mn[1] && ry <= mx[1] &&
            rz >= mn[2] && rz <= mx[2]) {
            for (int i = 0; i < n_lig; ++i) {
                const double dx = lig_xyz[3 * i] - rx;
                const double dy = lig_xyz[3 * i + 1] - ry;
                const double dz = lig_xyz[3 * i + 2] - rz;
                if (dx * dx + dy * dy + dz * dz < r2) {
                    hit = 1;
                    break;
                }
            }
        }
        keep[j] = hit;
        kept += hit;
    }
    return kept;
}

namespace {

// Emit edges for the atom set described by xyz/bp (size n), in the exact
// numpy ordering. Returns edge count, or -1 if cap exceeded.
//
// Uses a cell-list grid (cell size = max radius, 27-neighbourhood) so each
// block pass is O(n * degree) instead of O(n^2); per-row candidate lists
// are sorted ascending, which together with in-order row iteration
// reproduces the exact row-major ordering of the reference's dense
// adjacency scan. Falls back to the dense double loop when the bounding
// box is too sparse for a grid to pay off.
int64_t emit_edges_dense(const double* xyz, const int32_t* bp, int n,
                         double inter_r, double intra_r,
                         int32_t* rows, int32_t* cols, int32_t* attrs,
                         int64_t cap) {
    const double inter2 = inter_r * inter_r;
    const double intra2 = intra_r * intra_r;
    const double eps2 = 1e-7 * 1e-7;
    int64_t count = 0;
    // Inter-molecular block (mixed bp, dist < inter_r), row-major.
    for (int i = 0; i < n; ++i) {
        const double xi = xyz[3 * i], yi = xyz[3 * i + 1],
                     zi = xyz[3 * i + 2];
        for (int j = 0; j < n; ++j) {
            if (bp[i] == bp[j]) continue;
            const double dx = xi - xyz[3 * j];
            const double dy = yi - xyz[3 * j + 1];
            const double dz = zi - xyz[3 * j + 2];
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < inter2 && d2 > eps2) {
                if (count >= cap) return -1;
                rows[count] = i;
                cols[count] = j;
                attrs[count] = 1;
                ++count;
            }
        }
    }
    // Intra block: ALL close pairs regardless of bp (reference quirk);
    // class 2 iff both receptor, else 0.
    for (int i = 0; i < n; ++i) {
        const double xi = xyz[3 * i], yi = xyz[3 * i + 1],
                     zi = xyz[3 * i + 2];
        for (int j = 0; j < n; ++j) {
            const double dx = xi - xyz[3 * j];
            const double dy = yi - xyz[3 * j + 1];
            const double dz = zi - xyz[3 * j + 2];
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < intra2 && d2 > eps2) {
                if (count >= cap) return -1;
                rows[count] = i;
                cols[count] = j;
                attrs[count] = (bp[i] == 1 && bp[j] == 1) ? 2 : 0;
                ++count;
            }
        }
    }
    return count;
}

int64_t emit_edges(const double* xyz, const int32_t* bp, int n,
                   double inter_r, double intra_r,
                   int32_t* rows, int32_t* cols, int32_t* attrs,
                   int64_t cap) {
    const double cell = std::max(inter_r, intra_r);
    if (n < 64 || cell <= 0.0) {
        return emit_edges_dense(xyz, bp, n, inter_r, intra_r,
                                rows, cols, attrs, cap);
    }
    double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
    for (int i = 0; i < n; ++i) {
        for (int a = 0; a < 3; ++a) {
            const double v = xyz[3 * i + a];
            if (v < mn[a]) mn[a] = v;
            if (v > mx[a]) mx[a] = v;
        }
    }
    int64_t dims[3];
    for (int a = 0; a < 3; ++a) {
        dims[a] = static_cast<int64_t>((mx[a] - mn[a]) / cell) + 1;
    }
    const int64_t ncells = dims[0] * dims[1] * dims[2];
    if (ncells <= 0 || ncells > 64LL * n + 1024) {
        // Degenerate or very sparse span: the grid would cost more than
        // it saves.
        return emit_edges_dense(xyz, bp, n, inter_r, intra_r,
                                rows, cols, attrs, cap);
    }

    // CSR cell buckets via counting sort (atom order within a cell stays
    // ascending, preserved by the prefix-sum fill below).
    std::vector<int32_t> cell_of(n);
    std::vector<int32_t> starts(ncells + 1, 0);
    for (int i = 0; i < n; ++i) {
        const int64_t cx = static_cast<int64_t>((xyz[3 * i] - mn[0]) / cell);
        const int64_t cy =
            static_cast<int64_t>((xyz[3 * i + 1] - mn[1]) / cell);
        const int64_t cz =
            static_cast<int64_t>((xyz[3 * i + 2] - mn[2]) / cell);
        const int64_t c = (cx * dims[1] + cy) * dims[2] + cz;
        cell_of[i] = static_cast<int32_t>(c);
        ++starts[c + 1];
    }
    for (int64_t c = 0; c < ncells; ++c) starts[c + 1] += starts[c];
    std::vector<int32_t> bucket(n);
    {
        std::vector<int32_t> fill(starts.begin(), starts.end() - 1);
        for (int i = 0; i < n; ++i) bucket[fill[cell_of[i]]++] = i;
    }

    const double eps2 = 1e-7 * 1e-7;
    std::vector<int32_t> js;
    js.reserve(256);
    int64_t count = 0;
    // Two block passes (inter then intra) in reference order.
    for (int block = 0; block < 2; ++block) {
        const bool inter_block = block == 0;
        const double r2 = inter_block ? inter_r * inter_r
                                      : intra_r * intra_r;
        for (int i = 0; i < n; ++i) {
            const double xi = xyz[3 * i], yi = xyz[3 * i + 1],
                         zi = xyz[3 * i + 2];
            const int64_t c = cell_of[i];
            const int64_t cz = c % dims[2];
            const int64_t cy = (c / dims[2]) % dims[1];
            const int64_t cx = c / (dims[1] * dims[2]);
            js.clear();
            for (int64_t ax = std::max<int64_t>(cx - 1, 0);
                 ax <= std::min(cx + 1, dims[0] - 1); ++ax) {
                for (int64_t ay = std::max<int64_t>(cy - 1, 0);
                     ay <= std::min(cy + 1, dims[1] - 1); ++ay) {
                    const int64_t base = (ax * dims[1] + ay) * dims[2];
                    const int64_t z0 = std::max<int64_t>(cz - 1, 0);
                    const int64_t z1 = std::min(cz + 1, dims[2] - 1);
                    for (int32_t p = starts[base + z0];
                         p < starts[base + z1 + 1]; ++p) {
                        const int32_t j = bucket[p];
                        if (inter_block && bp[i] == bp[j]) continue;
                        const double dx = xi - xyz[3 * j];
                        const double dy = yi - xyz[3 * j + 1];
                        const double dz = zi - xyz[3 * j + 2];
                        const double d2 = dx * dx + dy * dy + dz * dz;
                        if (d2 < r2 && d2 > eps2) js.push_back(j);
                    }
                }
            }
            std::sort(js.begin(), js.end());
            if (count + static_cast<int64_t>(js.size()) > cap) return -1;
            for (const int32_t j : js) {
                rows[count] = i;
                cols[count] = j;
                attrs[count] = inter_block
                                   ? 1
                                   : ((bp[i] == 1 && bp[j] == 1) ? 2 : 0);
                ++count;
            }
        }
    }
    return count;
}

}  // namespace

// Radius-graph edges with optional pruning of atoms disconnected from the
// first inter-molecular edge's source. Outputs:
//   rows/cols/attrs: edge arrays (capacity `cap`);
//   keep: per-atom survival mask (all 1 when prune off or no inter edges).
// Returns the edge count, or -1 if cap was exceeded.
int64_t pvs_radius_edges(const double* xyz, const int32_t* bp, int n,
                         double inter_r, double intra_r, int prune,
                         int32_t* rows, int32_t* cols, int32_t* attrs,
                         int64_t cap, uint8_t* keep) {
    std::memset(keep, 1, n);
    int64_t count = emit_edges(xyz, bp, n, inter_r, intra_r,
                               rows, cols, attrs, cap);
    if (count < 0) return -1;

    bool has_inter = count > 0 && attrs[0] == 1;
    if (!prune || !has_inter) return count;

    // BFS over the undirected adjacency from rows[0].
    std::vector<std::vector<int32_t>> adj(n);
    for (int64_t e = 0; e < count; ++e) {
        adj[rows[e]].push_back(cols[e]);
        adj[cols[e]].push_back(rows[e]);
    }
    std::vector<uint8_t> seen(n, 0);
    std::vector<int32_t> stack{rows[0]};
    seen[rows[0]] = 1;
    while (!stack.empty()) {
        int32_t node = stack.back();
        stack.pop_back();
        for (int32_t child : adj[node]) {
            if (!seen[child]) {
                seen[child] = 1;
                stack.push_back(child);
            }
        }
    }
    bool dropped_any = false;
    for (int i = 0; i < n; ++i) {
        keep[i] = seen[i];
        dropped_any |= !seen[i];
    }
    if (!dropped_any) return count;

    // Regenerate edges over the kept subset with compacted indices
    // (mirrors the reference's recursive re-call after dropping rows).
    std::vector<double> sub_xyz;
    std::vector<int32_t> sub_bp;
    sub_xyz.reserve(3 * n);
    sub_bp.reserve(n);
    for (int i = 0; i < n; ++i) {
        if (keep[i]) {
            sub_xyz.push_back(xyz[3 * i]);
            sub_xyz.push_back(xyz[3 * i + 1]);
            sub_xyz.push_back(xyz[3 * i + 2]);
            sub_bp.push_back(bp[i]);
        }
    }
    return emit_edges(sub_xyz.data(), sub_bp.data(),
                      static_cast<int>(sub_bp.size()), inter_r, intra_r,
                      rows, cols, attrs, cap);
}

// Stable counting argsort for bounded non-negative ids (edge sorting at
// collation: O(E + max_id) vs numpy's comparison sort).
void pvs_counting_argsort(const int32_t* ids, int64_t n, int32_t max_id,
                          int32_t* out_order) {
    std::vector<int64_t> counts(static_cast<size_t>(max_id) + 2, 0);
    for (int64_t i = 0; i < n; ++i) counts[ids[i] + 1]++;
    for (size_t v = 1; v < counts.size(); ++v) counts[v] += counts[v - 1];
    for (int64_t i = 0; i < n; ++i) {
        out_order[counts[ids[i]]++] = static_cast<int32_t>(i);
    }
}

// The v3 wire format's host half of one collated edge list (e edges,
// node padding n_pad). The list is eligible when
//   - its (sender, receiver) pairs are in lexicographic order,
//   - every edge's mirror sits where recv_perm says:
//     senders[recv_perm[i]] == receivers[i] (with the collator's
//     receivers[recv_perm] == senders, each edge's mirror exists),
//   - every edge is padding (s == r == n_pad) or has s != r, both ids
//     below n_pad, and as many edges have s < r as s > r.
// Then the s < r edges, in list order, go to half_s / half_r as uint16
// and their classes (0-2) to half_bits, four 2-bit codes a byte, lowest
// bits first; the e/2 - n_up slots after them hold n_pad, n_pad and
// class 3. Returns n_up, or -1 for an ineligible list (nothing written
// is then meaningful).
int64_t pvs_symhalf(const int32_t* senders, const int32_t* receivers,
                    const int32_t* recv_perm, const uint8_t* edge_class,
                    int64_t e, int32_t n_pad, uint16_t* half_s,
                    uint16_t* half_r, uint8_t* half_bits) {
    if (e % 8 != 0 || n_pad < 0 || n_pad > 65535) return -1;
    const int64_t half = e / 2;
    int64_t up = 0, down = 0;
    for (int64_t i = 0; i < e; ++i) {
        const int32_t s = senders[i], r = receivers[i];
        if (i > 0) {
            const int32_t ps = senders[i - 1], pr = receivers[i - 1];
            if (s < ps || (s == ps && r < pr)) return -1;
        }
        const int32_t m = recv_perm[i];
        if (m < 0 || m >= e || senders[m] != r) return -1;
        if (s == n_pad && r == n_pad) continue;
        if (s < 0 || r < 0 || s >= n_pad || r >= n_pad || s == r) return -1;
        if (s < r) {
            ++up;
        } else {
            ++down;
        }
    }
    if (up != down) return -1;
    std::memset(half_bits, 0, static_cast<size_t>(half / 4));
    int64_t k = 0;
    for (int64_t i = 0; i < e; ++i) {
        if (senders[i] < receivers[i]) {
            half_s[k] = static_cast<uint16_t>(senders[i]);
            half_r[k] = static_cast<uint16_t>(receivers[i]);
            half_bits[k >> 2] |= static_cast<uint8_t>(
                (edge_class[i] & 3u) << (2 * (k & 3)));
            ++k;
        }
    }
    for (; k < half; ++k) {
        half_s[k] = static_cast<uint16_t>(n_pad);
        half_r[k] = static_cast<uint16_t>(n_pad);
        half_bits[k >> 2] |= static_cast<uint8_t>(3u << (2 * (k & 3)));
    }
    return up;
}

}  // extern "C"
