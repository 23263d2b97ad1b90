// Native host-side routines of isokann_tpu_torch.
//
// The host loops beside the device work: adaptive-sampling selection
// sweeps, sparse Bellman-Ford relaxation and DCD trajectory I/O, exposed
// through a C ABI consumed via ctypes (isokann_tpu_torch/native.py).  The
// same routines as native/host_ops.cpp of the JAX package.
//
// Build: at first use, g++ -O3 -fPIC -shared -std=c++17 into
// build/torch_kernels/host_ops-<hash>.so (isokann_tpu_torch/_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// pickclosest: sorted sweep matching needles to unique haystack entries.
// hs (sorted ascending, n), ns (sorted ascending, m) -> out indices (m).
// Mirrors the semantics of the Python _pickclosest_sorted
// (reference pickclosestloop, src/utils/subsample.jl:52-76).
// Returns the number of picks written.
// ---------------------------------------------------------------------------
int64_t pickclosest_sorted(const double* hs, int64_t n,
                           const double* ns, int64_t m,
                           int64_t* out) {
    if (n == 0 || m == 0) return 0;
    std::vector<uint8_t> avail(n, 1);
    // doubly linked list over available slots for O(1) neighbor hops
    std::vector<int64_t> nxt(n + 1), prv(n + 1);
    for (int64_t i = 0; i < n; ++i) { nxt[i] = i + 1; prv[i] = i - 1; }
    nxt[n] = n; prv[0] = -1;

    int64_t written = 0;
    int64_t i = 0;
    for (int64_t k = 0; k < m; ++k) {
        double needle = ns[k];
        double di = std::fabs(hs[i] - needle);
        for (;;) {
            int64_t j = nxt[i];
            if (j < n && std::fabs(hs[j] - needle) <= di) {
                di = std::fabs(hs[j] - needle);
                i = j;
            } else {
                out[written++] = i;
                avail[i] = 0;
                // unlink i
                int64_t p = prv[i], q = nxt[i];
                if (p >= 0) nxt[p] = q;
                if (q <= n) prv[q] = p;
                i = p;
                break;
            }
        }
        if (i < 0) {
            // find first available
            int64_t f = 0;
            while (f < n && !avail[f]) ++f;
            if (f == n) break;
            i = f;
        }
    }
    return written;
}

// ---------------------------------------------------------------------------
// ASH greedy resampler: given target probabilities p (m) for candidates ys
// (m) and an ASH histogram (counts over a uniform grid), iteratively pick
// argmax(p - pdf(y)) and deposit the pick into the histogram.
// Mirrors resample_kde_ash (reference src/utils/subsample.jl:127-177).
// ---------------------------------------------------------------------------
void ash_greedy(const double* ys, double* p, int64_t m,
                double* counts, int64_t nbins, double lo, double step,
                int64_t window, double n0, int64_t npick, int64_t* out) {
    auto binindex = [&](double x) -> int64_t {
        int64_t idx = (int64_t)std::llround((x - lo) / step);
        if (idx < 0) idx = 0;
        if (idx >= nbins) idx = nbins - 1;
        return idx;
    };
    double n = n0;
    double h = (double)window * step;
    // per-candidate bin indices
    std::vector<int64_t> ybin(m);
    for (int64_t i = 0; i < m; ++i) ybin[i] = binindex(ys[i]);

    // density via triangular smoothing evaluated lazily per candidate
    auto pdf_at = [&](int64_t bi) -> double {
        double acc = 0.0;
        int64_t a = std::max<int64_t>(0, bi - window + 1);
        int64_t b = std::min<int64_t>(nbins - 1, bi + window - 1);
        for (int64_t j = a; j <= b; ++j) {
            double w = 1.0 - (double)std::llabs(j - bi) / (double)window;
            acc += w * counts[j];
        }
        return acc / (n * h);
    };

    for (int64_t k = 0; k < npick; ++k) {
        double best = -std::numeric_limits<double>::infinity();
        int64_t bi = 0;
        for (int64_t i = 0; i < m; ++i) {
            double delta = p[i] - pdf_at(ybin[i]);
            if (delta > best) { best = delta; bi = i; }
        }
        out[k] = bi;
        p[bi] = 0.0;
        counts[ybin[bi]] += 1.0;
        n += 1.0;
    }
}

// ---------------------------------------------------------------------------
// Sparse Bellman-Ford over a CSR graph (host analog of the reference's
// CUDA kernel, src/utils/reactivepath.jl:252-296).
// indptr (n+1), indices (nnz), weights (nnz); dist/parent outputs (n).
// sources: ns source nodes.
// ---------------------------------------------------------------------------
void bellman_ford_csr(const int64_t* indptr, const int64_t* indices,
                      const double* weights, int64_t n,
                      const int64_t* sources, int64_t ns,
                      double* dist, int64_t* parent) {
    const double INF = std::numeric_limits<double>::infinity();
    for (int64_t i = 0; i < n; ++i) { dist[i] = INF; parent[i] = -1; }
    for (int64_t s = 0; s < ns; ++s) dist[sources[s]] = 0.0;

    bool changed = true;
    for (int64_t it = 0; it < n && changed; ++it) {
        changed = false;
        for (int64_t u = 0; u < n; ++u) {
            double du = dist[u];
            if (du == INF) continue;
            for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                int64_t v = indices[e];
                double nd = du + weights[e];
                if (nd < dist[v] - 1e-12) {
                    dist[v] = nd;
                    parent[v] = u;
                    changed = true;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Greedy farthest-point picking over rows of X (npts x d), starting from
// the point farthest from the origin (reference src/utils/picking.jl:16-43).
// ---------------------------------------------------------------------------
void picking_maxmin(const double* X, int64_t npts, int64_t d,
                    int64_t npick, int64_t* out, double* mins_out) {
    std::vector<double> mins(npts, std::numeric_limits<double>::infinity());
    // start: farthest from origin
    int64_t q = 0;
    double best = -1.0;
    for (int64_t i = 0; i < npts; ++i) {
        double s = 0.0;
        for (int64_t j = 0; j < d; ++j) s += X[i * d + j] * X[i * d + j];
        if (s > best) { best = s; q = i; }
    }
    for (int64_t k = 0; k < npick; ++k) {
        out[k] = q;
        const double* xq = X + q * d;
        double nb = -1.0;
        int64_t nq = 0;
        for (int64_t i = 0; i < npts; ++i) {
            double s = 0.0;
            for (int64_t j = 0; j < d; ++j) {
                double diff = X[i * d + j] - xq[j];
                s += diff * diff;
            }
            if (s < mins[i]) mins[i] = s;
            if (mins[i] > nb) { nb = mins[i]; nq = i; }
        }
        q = nq;
    }
    if (mins_out) std::memcpy(mins_out, mins.data(), npts * sizeof(double));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// DCD trajectory I/O (CHARMM/NAMD binary format) — interop with VMD,
// mdtraj, MDAnalysis.  The reference reads/writes binary trajectories
// through Chemfiles/mdtraj (C/C++ libraries, src/utils/molutils.jl:75-189);
// this is the native equivalent for the rebuild.
//
// Layout: Fortran unformatted records ([i32 len][payload][i32 len]):
//   "CORD" + ICNTL[20]  (nframes, start, step, ..., has_cell @ [10],
//                        version 24 @ [19])
//   title block, natoms block; per frame: optional unit cell
//   (6 doubles: A, gamma, B, beta, alpha, C) then X, Y, Z float32 blocks.
// Coordinates are Angstrom in-file; the API converts nm <-> A.
// ---------------------------------------------------------------------------

#include <cstdio>

namespace {
bool wrec(FILE* f, const void* data, int32_t n) {
    return std::fwrite(&n, 4, 1, f) == 1
        && (n == 0 || std::fwrite(data, 1, (size_t)n, f) == (size_t)n)
        && std::fwrite(&n, 4, 1, f) == 1;
}

inline int32_t bsw32i(int32_t v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    u = __builtin_bswap32(u);
    std::memcpy(&v, &u, 4);
    return v;
}

// swap every 4-byte word in place (i32 / f32 payloads)
void bswap_words4(void* data, size_t nwords) {
    uint32_t* p = static_cast<uint32_t*>(data);
    for (size_t i = 0; i < nwords; ++i) p[i] = __builtin_bswap32(p[i]);
}

// swap every 8-byte word in place (f64 payloads)
void bswap_words8(void* data, size_t nwords) {
    uint64_t* p = static_cast<uint64_t*>(data);
    for (size_t i = 0; i < nwords; ++i) p[i] = __builtin_bswap64(p[i]);
}

bool rrec(FILE* f, void* data, int32_t expect, int32_t* got,
          bool swap = false) {
    int32_t n = 0, n2 = 0;
    if (std::fread(&n, 4, 1, f) != 1) return false;
    if (swap) n = bsw32i(n);
    if (got) *got = n;
    if (expect >= 0 && n != expect) return false;
    if (n < 0) return false;
    if (data) {
        if (std::fread(data, 1, (size_t)n, f) != (size_t)n) return false;
    } else {
        if (std::fseek(f, n, SEEK_CUR) != 0) return false;
    }
    if (std::fread(&n2, 4, 1, f) != 1) return false;
    if (swap) n2 = bsw32i(n2);
    return n2 == n;
}

// Opposite-endian DCD files (e.g. big-endian CHARMM output read on x86)
// announce themselves through a byte-swapped 84 header-record marker.
// Returns false if the first marker is neither 84 nor bswap(84).
bool dcd_detect_swap(FILE* f, bool* swap) {
    int32_t n = 0;
    if (std::fread(&n, 4, 1, f) != 1) return false;
    if (std::fseek(f, 0, SEEK_SET) != 0) return false;
    if (n == 84) { *swap = false; return true; }
    if (bsw32i(n) == 84) { *swap = true; return true; }
    return false;
}
}  // namespace

extern "C" {

// Write (nframes, natoms, 3) nm coordinates; box: 3 doubles [nm] or null.
// Returns 0 on success.
int64_t dcd_write(const char* path, const float* xyz, int64_t nframes,
                  int64_t natoms, const double* box, double dt_ps) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    struct { char magic[4]; int32_t icntl[20]; } hdr;
    std::memcpy(hdr.magic, "CORD", 4);
    std::memset(hdr.icntl, 0, sizeof(hdr.icntl));
    hdr.icntl[0] = (int32_t)nframes;   // NSET
    hdr.icntl[1] = 1;                  // ISTART
    hdr.icntl[2] = 1;                  // NSAVC
    float delta = (float)(dt_ps * 20.455);  // AKMA units per CHARMM
    std::memcpy(&hdr.icntl[9], &delta, 4);
    hdr.icntl[10] = box ? 1 : 0;       // crystal flag
    hdr.icntl[19] = 24;                // CHARMM version
    bool ok = wrec(f, &hdr, 84);
    struct { int32_t nt; char line[80]; } title;
    title.nt = 1;
    std::memset(title.line, ' ', 80);
    std::memcpy(title.line, "written by isokann_tpu", 22);
    ok = ok && wrec(f, &title, 84);
    int32_t na = (int32_t)natoms;
    ok = ok && wrec(f, &na, 4);

    std::vector<float> buf(natoms);
    for (int64_t t = 0; ok && t < nframes; ++t) {
        if (box) {
            // XTL order: A, gamma, B, beta, alpha, C (orthorhombic: 90s)
            double cell[6] = {box[0] * 10.0, 90.0, box[1] * 10.0,
                              90.0, 90.0, box[2] * 10.0};
            ok = wrec(f, cell, 48);
        }
        for (int c = 0; ok && c < 3; ++c) {
            const float* fr = xyz + (t * natoms) * 3;
            for (int64_t a = 0; a < natoms; ++a)
                buf[a] = fr[a * 3 + c] * 10.0f;     // nm -> Angstrom
            ok = wrec(f, buf.data(), (int32_t)(natoms * 4));
        }
    }
    std::fclose(f);
    return ok ? 0 : 2;
}

// Probe natoms / nframes / cell flag.  Returns 0 on success.
int64_t dcd_info(const char* path, int64_t* natoms, int64_t* nframes,
                 int64_t* has_cell) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    bool sw = false;
    if (!dcd_detect_swap(f, &sw)) { std::fclose(f); return 2; }
    struct { char magic[4]; int32_t icntl[20]; } hdr;
    if (!rrec(f, &hdr, 84, nullptr, sw) || std::memcmp(hdr.magic, "CORD", 4)) {
        std::fclose(f);
        return 2;
    }
    if (sw) bswap_words4(hdr.icntl, 20);
    if (!rrec(f, nullptr, -1, nullptr, sw)) { std::fclose(f); return 2; }  // title
    int32_t na = 0;
    if (!rrec(f, &na, 4, nullptr, sw)) { std::fclose(f); return 2; }
    if (sw) na = bsw32i(na);
    *natoms = na;
    *has_cell = hdr.icntl[10] ? 1 : 0;
    // count frames by scanning records (header NSET can be stale)
    int64_t frames = 0;
    for (;;) {
        if (hdr.icntl[10] && !rrec(f, nullptr, 48, nullptr, sw)) break;
        bool ok = true;
        for (int c = 0; c < 3; ++c)
            ok = ok && rrec(f, nullptr, (int32_t)(na * 4), nullptr, sw);
        if (!ok) break;
        ++frames;
    }
    *nframes = frames;
    std::fclose(f);
    return 0;
}

// Read all frames into (nframes, natoms, 3) nm + per-frame box [nm]
// (boxes zero-filled when the file has no cell).  Returns 0 on success.
int64_t dcd_read(const char* path, float* xyz, double* boxes,
                 int64_t maxframes) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    bool sw = false;
    if (!dcd_detect_swap(f, &sw)) { std::fclose(f); return 2; }
    struct { char magic[4]; int32_t icntl[20]; } hdr;
    if (!rrec(f, &hdr, 84, nullptr, sw) || std::memcmp(hdr.magic, "CORD", 4)) {
        std::fclose(f);
        return 2;
    }
    if (sw) bswap_words4(hdr.icntl, 20);
    if (!rrec(f, nullptr, -1, nullptr, sw)) { std::fclose(f); return 2; }
    int32_t na = 0;
    if (!rrec(f, &na, 4, nullptr, sw)) { std::fclose(f); return 2; }
    if (sw) na = bsw32i(na);
    std::vector<float> buf(na);
    for (int64_t t = 0; t < maxframes; ++t) {
        if (hdr.icntl[10]) {
            double cell[6];
            if (!rrec(f, cell, 48, nullptr, sw)) break;
            if (sw) bswap_words8(cell, 6);
            if (boxes) {
                boxes[t * 3 + 0] = cell[0] / 10.0;
                boxes[t * 3 + 1] = cell[2] / 10.0;
                boxes[t * 3 + 2] = cell[5] / 10.0;
            }
        } else if (boxes) {
            boxes[t * 3] = boxes[t * 3 + 1] = boxes[t * 3 + 2] = 0.0;
        }
        bool ok = true;
        for (int c = 0; c < 3 && ok; ++c) {
            ok = rrec(f, buf.data(), (int32_t)(na * 4), nullptr, sw);
            if (ok) {
                if (sw) bswap_words4(buf.data(), (size_t)na);
                for (int64_t a = 0; a < na; ++a)
                    xyz[(t * na + a) * 3 + c] = buf[a] * 0.1f;  // A -> nm
            }
        }
        if (!ok) break;
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
