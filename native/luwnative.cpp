// Native runtime components for latticeurbanwind_tpu.
//
// Analog of the reference's C++ host runtime pieces: the
// triangle-parity voxelizer (reference does this as an OpenCL kernel,
// kernel.cpp:2381-2478) and the big-endian VTK payload encoder
// (reference: utilities.hpp reverse_bytes loop in lbm.hpp write_vtk).
// Exposed as a plain C ABI and loaded from Python via ctypes.
//
// Build: g++ -O3 -fPIC -shared -o libluwnative.so luwnative.cpp -fopenmp? (no:
// single-threaded; column loop is parallelized with std::thread).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Byte-swap float32 array to big-endian, AoS-interleaving `comp` component
// planes: dst[n*comp + c] = bswap(src[c*n_points + n]).
void encode_be_f32_aos(const float* src, int64_t n_points, int64_t comp,
                       float* dst) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int64_t n = 0; n < n_points; ++n) {
        for (int64_t c = 0; c < comp; ++c) {
            d[n * comp + c] = __builtin_bswap32(s[c * n_points + n]);
        }
    }
}

// Column-parity voxelization of a triangle soup in lattice units.
// tris: (ntri, 3, 3) float64 vertices (x, y, z); out: (Z, Y, X) uint8 mask.
// Cell (z, y, x) center = (x+0.5, y+0.5, z+0.5). For every column a vertical
// ray collects triangle crossings; odd-parity intervals are solid; an odd
// total crossing count treats the solid as extending down from the first
// crossing (terrain clipped at the domain floor).
void voxelize_columns(const double* tris, int64_t ntri,
                      int64_t Z, int64_t Y, int64_t X,
                      double jitter, uint8_t* out) {
    std::memset(out, 0, static_cast<size_t>(Z) * Y * X);
    const int64_t ncol = Y * X;

    // precompute per-triangle 2-D projection data
    std::vector<double> x0(ntri), y0(ntri), x1(ntri), y1(ntri), x2(ntri), y2(ntri);
    std::vector<double> z0(ntri), z1v(ntri), z2(ntri), inv(ntri);
    std::vector<double> bbx0(ntri), bbx1(ntri), bby0(ntri), bby1(ntri);
    for (int64_t t = 0; t < ntri; ++t) {
        const double* v = tris + t * 9;
        x0[t] = v[0]; y0[t] = v[1]; z0[t] = v[2];
        x1[t] = v[3]; y1[t] = v[4]; z1v[t] = v[5];
        x2[t] = v[6]; y2[t] = v[7]; z2[t] = v[8];
        const double denom = (y1[t] - y2[t]) * (x0[t] - x2[t])
                           + (x2[t] - x1[t]) * (y0[t] - y2[t]);
        inv[t] = (std::fabs(denom) > 1e-12) ? 1.0 / denom : 0.0;
        bbx0[t] = std::min({x0[t], x1[t], x2[t]});
        bbx1[t] = std::max({x0[t], x1[t], x2[t]});
        bby0[t] = std::min({y0[t], y1[t], y2[t]});
        bby1[t] = std::max({y0[t], y1[t], y2[t]});
    }

    // bin triangles by x-column strips to avoid the all-pairs scan
    std::vector<std::vector<int32_t>> strip(static_cast<size_t>(X));
    for (int64_t t = 0; t < ntri; ++t) {
        if (inv[t] == 0.0) continue;
        int64_t i0 = std::max<int64_t>(0, (int64_t)std::floor(bbx0[t] - 0.5));
        int64_t i1 = std::min<int64_t>(X - 1, (int64_t)std::ceil(bbx1[t] - 0.5));
        for (int64_t i = i0; i <= i1; ++i) strip[(size_t)i].push_back((int32_t)t);
    }

    auto work = [&](int64_t col_begin, int64_t col_end) {
        std::vector<double> zs;
        for (int64_t col = col_begin; col < col_end; ++col) {
            const int64_t yi = col / X;
            const int64_t xi = col % X;
            const double px = xi + 0.5 + jitter;
            const double py = yi + 0.5 + jitter * 1.618;
            zs.clear();
            for (int32_t t : strip[(size_t)xi]) {
                if (py < bby0[t] - 1e-12 || py > bby1[t] + 1e-12) continue;
                const double l0 = ((y1[t] - y2[t]) * (px - x2[t])
                                 + (x2[t] - x1[t]) * (py - y2[t])) * inv[t];
                const double l1 = ((y2[t] - y0[t]) * (px - x2[t])
                                 + (x0[t] - x2[t]) * (py - y2[t])) * inv[t];
                const double l2 = 1.0 - l0 - l1;
                // half-open edge rule matches the Python voxelizer
                if (l0 >= 0.0 && l1 >= 0.0 && l2 > 0.0 && l0 <= 1.0 && l1 <= 1.0) {
                    zs.push_back(l0 * z0[t] + l1 * z1v[t] + l2 * z2[t]);
                }
            }
            if (zs.empty()) continue;
            std::sort(zs.begin(), zs.end());
            size_t start = 0;
            bool from_below = (zs.size() % 2) == 1;
            for (int64_t k = 0; k < Z; ++k) {
                const double zc = k + 0.5;
                // count crossings at or below the cell center ([lo, hi)
                // interval convention, matching the numpy path)
                size_t below = std::upper_bound(zs.begin(), zs.end(), zc)
                               - zs.begin();
                bool inside = from_below ? (below % 2 == 0 && below < zs.size())
                                         : (below % 2 == 1);
                if (inside) out[(k * Y + yi) * X + xi] = 1;
            }
            (void)start;
        }
    };

    unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    if (ncol < 4096) nthreads = 1;
    std::vector<std::thread> pool;
    const int64_t per = (ncol + nthreads - 1) / nthreads;
    for (unsigned i = 0; i < nthreads; ++i) {
        const int64_t b = i * per;
        const int64_t e = std::min<int64_t>(ncol, b + per);
        if (b >= e) break;
        pool.emplace_back(work, b, e);
    }
    for (auto& th : pool) th.join();
}

// Parse a numeric CSV body into a row-major double table.
//
// The reference reads SurfData with a per-line std::stod loop
// (setup.cpp:2291-2440 read_samples); production boundary files reach
// hundreds of thousands of rows, where Python-level splitting costs
// seconds.  Cells that are empty or non-numeric become NaN; rows with no
// numeric cell are skipped.  Returns the number of rows written (capped at
// max_rows); *n_cols_out reports the widest row seen (capped at max_cols).
int64_t parse_csv_doubles(const char* buf, int64_t len, int64_t max_cols,
                          int64_t max_rows, double* out,
                          int64_t* n_cols_out) {
    int64_t row = 0;
    int64_t widest = 0;
    int64_t i = 0;
    const double nan = std::nan("");
    while (i < len && row < max_rows) {
        // one line
        int64_t col = 0;
        bool any = false;
        double* dst = out + row * max_cols;
        for (int64_t c = 0; c < max_cols; ++c) dst[c] = nan;
        while (i < len) {
            // one cell
            const char* start = buf + i;
            int64_t cell_len = 0;
            while (i < len && buf[i] != ',' && buf[i] != '\n' && buf[i] != '\r') {
                ++i; ++cell_len;
            }
            if (col < max_cols) {
                char* end = nullptr;
                double v = std::strtod(start, &end);
                // accept only fully-numeric cells (modulo surrounding spaces)
                const char* q = end;
                while (q < start + cell_len && (*q == ' ' || *q == '\t')) ++q;
                const char* s0 = start;
                while (s0 < start + cell_len && (*s0 == ' ' || *s0 == '\t')) ++s0;
                if (end > s0 && q == start + cell_len) {
                    dst[col] = v;
                    any = true;
                }
            }
            ++col;
            if (i < len && buf[i] == ',') { ++i; continue; }
            break;
        }
        while (i < len && (buf[i] == '\r' || buf[i] == '\n')) ++i;
        if (any) {
            if (col > widest) widest = col;
            ++row;
        }
    }
    *n_cols_out = widest < max_cols ? widest : max_cols;
    return row;
}

}  // extern "C"
