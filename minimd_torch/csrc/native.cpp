// Host runtime of minimd_torch: the set-up and data-file hot paths in C++.
//
// The port's own copy of the JAX package's native host runtime (the
// glibc rand() type stream, ref/atom.cpp:97; the FCC lattice with
// Park-Miller velocities, ref/setup.cpp:315-517; the LAMMPS data-file
// reader, ref/setup.cpp:55-301). Built with the host C++ compiler by
// minimd_torch/_build.py build_host() (-O2, no -ffast-math, no FMA
// contraction) and called through ctypes from minimd_torch/native.py.
// Its arithmetic is that of the numpy bodies in minimd_torch/create.py
// and minimd_torch/rng.py, so the arrays are bit for bit theirs.
//
// The reader follows minimd_torch/lammps_data.py read_lammps_data_plain
// line for line (a header, then sections), where the JAX package's C++
// reader did not: it refuses an atom id outside 1..natoms and a row with
// fewer columns than its section needs (the JAX reader wrote outside its
// buffer for the first), and the last row of a Masses section gives the
// mass (the JAX C++ reader kept the first, its Python reader the last).
//
// A plain C ABI for ctypes.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// glibc rand() (TYPE_3 additive feedback): srand(seed), then n draws
// ---------------------------------------------------------------------------

// n draws of rand() % ntypes into out (the generator of rng.GlibcRand).
void mmd_rand_types(unsigned seed, int64_t n, int ntypes, int32_t* out) {
    if (seed == 0) seed = 1;
    uint32_t r[344];
    int32_t* ri = reinterpret_cast<int32_t*>(r);
    ri[0] = (int32_t)seed;
    for (int i = 1; i < 31; i++) {
        long long hi = ri[i - 1] / 127773;
        long long lo = ri[i - 1] % 127773;
        long long word = 16807 * lo - 2836 * hi;
        if (word < 0) word += 2147483647;
        ri[i] = (int32_t)word;
    }
    for (int i = 31; i < 34; i++) r[i] = r[i - 31];
    for (int i = 34; i < 344; i++) r[i] = r[i - 31] + r[i - 3];
    // a circular window of the last 344 words: word k = r[k-31] + r[k-3]
    int pos = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t word = r[(pos + 344 - 31) % 344] + r[(pos + 344 - 3) % 344];
        r[pos] = word;
        pos = (pos + 1) % 344;
        out[i] = (int32_t)((word >> 1) % (unsigned)ntypes);
    }
}

// ---------------------------------------------------------------------------
// Park-Miller minimal standard (Schrage), ref/setup.cpp:505-517
// ---------------------------------------------------------------------------

static inline double pm_random(int32_t* idum) {
    const int32_t IA = 16807, IM = 2147483647, IQ = 127773, IR = 2836;
    int32_t k = *idum / IQ;
    *idum = IA * (*idum - k * IQ) - IR * k;
    if (*idum < 0) *idum += IM;
    return (1.0 / IM) * (*idum);
}

// The velocity of a lattice site: a stream seeded by the 1-based global
// half-lattice site index, 5 warm-up draws before each component.
static inline void site_velocity(int32_t site_seed, double* v3) {
    int32_t s = site_seed;
    for (int c = 0; c < 3; c++) {
        for (int m = 0; m < 5; m++) pm_random(&s);
        v3[c] = pm_random(&s);
    }
}

// The FCC sites inside bounds (xlo xhi ylo yhi zlo zhi), in the
// reference's traversal: blocks of 8^3 half-cells, x fastest, sites in a
// block likewise (ref/setup.cpp:355-421). Returns the count, or -1 if it
// would pass capacity.
int64_t mmd_create_atoms(int nx, int ny, int nz, double rho,
                         const double* bounds, int64_t capacity,
                         double* out_x, double* out_v) {
    const double alat = pow(4.0 / rho, 1.0 / 3.0);
    const double half = 0.5 * alat;
    const double xlo = bounds[0], xhi = bounds[1];
    const double ylo = bounds[2], yhi = bounds[3];
    const double zlo = bounds[4], zhi = bounds[5];

    int ilo = (int)(xlo / half - 1); if (ilo < 0) ilo = 0;
    int ihi = (int)(xhi / half + 1); if (ihi > 2 * nx - 1) ihi = 2 * nx - 1;
    int jlo = (int)(ylo / half - 1); if (jlo < 0) jlo = 0;
    int jhi = (int)(yhi / half + 1); if (jhi > 2 * ny - 1) jhi = 2 * ny - 1;
    int klo = (int)(zlo / half - 1); if (klo < 0) klo = 0;
    int khi = (int)(zhi / half + 1); if (khi > 2 * nz - 1) khi = 2 * nz - 1;

    const int B = 8;
    const int nbi = ihi / B, nbj = jhi / B, nbk = khi / B;

    int64_t count = 0;
    for (int bk = 0; bk <= nbk; bk++)
    for (int bj = 0; bj <= nbj; bj++)
    for (int bi = 0; bi <= nbi; bi++)
        for (int dk = 0; dk < B; dk++)
        for (int dj = 0; dj < B; dj++)
        for (int di = 0; di < B; di++) {
            const int i = bi * B + di;
            const int j = bj * B + dj;
            const int k = bk * B + dk;
            if ((i + j + k) % 2 != 0) continue;
            if (i < ilo || i > ihi || j < jlo || j > jhi ||
                k < klo || k > khi) continue;
            const double xt = half * i, yt = half * j, zt = half * k;
            if (xt < xlo || xt >= xhi || yt < ylo || yt >= yhi ||
                zt < zlo || zt >= zhi) continue;
            if (count >= capacity) return -1;
            out_x[count * 3 + 0] = xt;
            out_x[count * 3 + 1] = yt;
            out_x[count * 3 + 2] = zt;
            site_velocity(k * (2 * ny) * (2 * nx) + j * (2 * nx) + i + 1,
                          out_v + count * 3);
            count++;
        }
    return count;
}

// ---------------------------------------------------------------------------
// LAMMPS data-file reader (ref/setup.cpp:55-301)
// ---------------------------------------------------------------------------

enum {
    MMD_NO_FILE = -1,       // cannot open the file
    MMD_BAD_ID = -2,        // an atom id outside 1..natoms
    MMD_SHORT_ROW = -3,     // fewer columns than the section needs
    MMD_BAD_NUMBER = -4,    // a column that is not a number
    MMD_NO_ATOMS = -5,      // no section at all (no Atoms)
    MMD_NATOMS = -6,        // natoms differs from the buffers' rows
};

// Splits s (comment cut, any whitespace) into at most `most` tokens.
static int split(char* s, char** tok, int most) {
    char* hash = strchr(s, '#');
    if (hash) *hash = '\0';
    int n = 0;
    while (*s) {
        while (*s && isspace((unsigned char)*s)) s++;
        if (!*s) break;
        if (n == most) return n + 1;   // more than `most`
        tok[n++] = s;
        while (*s && !isspace((unsigned char)*s)) s++;
        if (*s) *s++ = '\0';
    }
    return n;
}

static bool to_double(const char* s, double* out) {
    char* end;
    *out = strtod(s, &end);
    return end != s && *end == '\0';
}

static bool to_int(const char* s, long long* out) {
    char* end;
    *out = strtoll(s, &end, 10);
    return end != s && *end == '\0';
}

// With x_out == NULL: reads the header up to the first section title and
// returns natoms (box and mass untouched). Else reads the whole file into
// x_out and v_out (natoms rows of 3, zeroed by the caller; rows scattered
// by 1-based id), box_out (xprd yprd zprd) and mass_out (1.0 without a
// Masses section), and returns natoms. A negative return is an MMD_ code;
// *line_out is then the 1-based line at fault (0 for none).
int64_t mmd_read_lammps_data(const char* path, int64_t natoms_buf,
                             double* box_out, double* mass_out,
                             double* x_out, double* v_out,
                             int64_t* line_out) {
    FILE* fp = fopen(path, "r");
    *line_out = 0;
    if (!fp) return MMD_NO_FILE;
    char* line = nullptr;
    size_t cap = 0;
    int64_t lineno = 0;
    long long natoms = 0;
    double xlo = 0, xhi = 0, ylo = 0, yhi = 0, zlo = 0, zhi = 0;
    double mass = 1.0;
    int section = 0;   // 0 header, 1 Atoms, 2 Velocities, 3 Masses
    bool section_seen = false;
    int64_t rc = 0;
    char* tok[6];

    if (getline(&line, &cap, fp) >= 0) lineno++;   // the title
    while (rc == 0 && getline(&line, &cap, fp) >= 0) {
        lineno++;
        int n = split(line, tok, 5);
        if (n == 0) continue;
        int title = !strcmp(tok[0], "Atoms") ? 1
                    : !strcmp(tok[0], "Velocities") ? 2
                    : !strcmp(tok[0], "Masses") ? 3 : 0;
        if (title) {
            if (!x_out) break;   // header only
            if (natoms != natoms_buf) { rc = MMD_NATOMS; break; }
            section = title;
            section_seen = true;
            continue;
        }
        if (section == 0) {
            if (n == 2 && !strcmp(tok[1], "atoms")) {
                if (!to_int(tok[0], &natoms)) rc = MMD_BAD_NUMBER;
            } else if (n == 4 && !strcmp(tok[3], "xhi")
                       && !strcmp(tok[2], "xlo")) {
                if (!to_double(tok[0], &xlo) || !to_double(tok[1], &xhi))
                    rc = MMD_BAD_NUMBER;
            } else if (n == 4 && !strcmp(tok[3], "yhi")
                       && !strcmp(tok[2], "ylo")) {
                if (!to_double(tok[0], &ylo) || !to_double(tok[1], &yhi))
                    rc = MMD_BAD_NUMBER;
            } else if (n == 4 && !strcmp(tok[3], "zhi")
                       && !strcmp(tok[2], "zlo")) {
                if (!to_double(tok[0], &zlo) || !to_double(tok[1], &zhi))
                    rc = MMD_BAD_NUMBER;
            }
            // other header counts ("N atom types"): the caller assigns
            // the types, as the reference does
            continue;
        }
        if (section == 3) {
            double m;
            if (n < 2) rc = MMD_SHORT_ROW;
            else if (!to_double(tok[1], &m)) rc = MMD_BAD_NUMBER;
            else mass = m;   // the last row wins
            continue;
        }
        // Atoms: id type x y z; Velocities: id vx vy vz
        const int first = section == 1 ? 2 : 1;
        long long id;
        double c[3];
        if (n < first + 3) { rc = MMD_SHORT_ROW; continue; }
        if (!to_int(tok[0], &id) || !to_double(tok[first], &c[0])
            || !to_double(tok[first + 1], &c[1])
            || !to_double(tok[first + 2], &c[2])) {
            rc = MMD_BAD_NUMBER;
            continue;
        }
        if (id < 1 || id > natoms) { rc = MMD_BAD_ID; continue; }
        double* out = (section == 1 ? x_out : v_out) + (id - 1) * 3;
        out[0] = c[0];
        out[1] = c[1];
        out[2] = c[2];
    }
    free(line);
    fclose(fp);
    if (rc != 0) {
        *line_out = lineno;
        return rc;
    }
    if (!x_out) return natoms;
    if (!section_seen) return MMD_NO_ATOMS;
    box_out[0] = xhi - xlo;
    box_out[1] = yhi - ylo;
    box_out[2] = zhi - zlo;
    *mass_out = mass;
    return natoms;
}

}  // extern "C"
