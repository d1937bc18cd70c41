// rt_native — native host runtime for rendering_jax.
//
// The reference engine is 100% C++ (SURVEY section 2); the device compute
// path here is JAX/XLA, but the host-side scene pipeline (OBJ parsing,
// mesh transform, SAH BVH construction) is implemented natively too:
// for 250k-triangle meshes the Python/numpy builder costs seconds while
// this library does the same work in tens of milliseconds.
//
// SEMANTICS CONTRACT: bit-for-bit float32 parity with the Python
// implementations in rendering_jax/models/objloader.py and
// rendering_jax/accel/bvh.py (which themselves replicate the reference
// reference's src/objects.cpp:177-763 quirks: FLT_MIN max-init,
// normalize-on-first-face, rotated-size root bounds, duplication-based
// SAH splits, depth*ac_penalty leaf rule). Equality is enforced by
// tests/test_native.py on the bundled assets.
//
// C ABI, consumed via ctypes. Build: make -C native

#include <cctype>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct V3 { float x, y, z; };
struct V2 { float u, v; };

inline float vlen2(const V3& a) { return a.x * a.x + a.y * a.y + a.z * a.z; }

inline V3 vnorm(const V3& a) {
    float l2 = vlen2(a);
    if (l2 > 0.0f) {
        float f = 1.0f / std::sqrt(l2);
        return {a.x * f, a.y * f, a.z * f};
    }
    return a;
}

// Row-vector rotate: out[j] = a0*r[0][j] + a1*r[1][j] + a2*r[2][j]
inline V3 rot_row(const V3& a, const float r[9]) {
    return {
        a.x * r[0] + a.y * r[3] + a.z * r[6],
        a.x * r[1] + a.y * r[4] + a.z * r[7],
        a.x * r[2] + a.y * r[5] + a.z * r[8],
    };
}

struct MeshResult {
    std::vector<float> v;          // T*3*3
    std::vector<float> n;          // T*3*3
    std::vector<float> uv;         // T*3*2
    std::vector<float> tangent;    // T*3
    std::vector<float> bitangent;  // T*3
    float root_bounds[6] = {0};
    int64_t n_tris = 0;
};

struct BvhResult {
    std::vector<float> node_min;    // N*3
    std::vector<float> node_max;    // N*3
    std::vector<int32_t> skip;      // N
    std::vector<int32_t> leaf_start;
    std::vector<int32_t> leaf_count;
    std::vector<int32_t> real_flag;
    std::vector<int32_t> leaf_tris; // L (+chunk pad)
    std::vector<float> reach_lo;    // T*3 — union-AABB of leaves per tri
    std::vector<float> reach_hi;    // T*3
    int64_t n_real_nodes = 0;
    int64_t tri_copies = 0;
};

}  // namespace

extern "C" {

// ------------------------------ OBJ loader ------------------------------

void* rtn_load_obj(const char* path, const float* size3, const float* rmat9,
                   const float* pos3, float bias) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;

    auto* res = new MeshResult();
    std::vector<V3> verts, normals;
    std::vector<V2> uvs;
    // face index triples (0-based; -1 for missing)
    std::vector<int64_t> fv, fn, ft;
    bool normalized = false;

    const V3 size = {size3[0], size3[1], size3[2]};
    const V3 pos = {pos3[0], pos3[1], pos3[2]};
    V3 vmin = {FLT_MAX, FLT_MAX, FLT_MAX};
    // NOT -FLT_MAX: the reference initializes with
    // std::numeric_limits<float>::min() (objects.cpp:229).
    V3 vmax = {FLT_MIN, FLT_MIN, FLT_MIN};
    float rng[3] = {0, 0, 0};
    V3 norm_size = size;

    auto apply_first_face = [&]() {
        normalized = true;
        rng[0] = vmax.x - vmin.x;
        rng[1] = vmax.y - vmin.y;
        rng[2] = vmax.z - vmin.z;
        bool degen = rng[0] < bias || rng[1] < bias || rng[2] < bias;
        if (!degen) {
            float sx = size.x / rng[0], sy = size.y / rng[1], sz = size.z / rng[2];
            float mn = sx < sy ? (sx < sz ? sx : sz) : (sy < sz ? sy : sz);
            if (mn == sx) {
                norm_size.y = norm_size.x / (rng[0] / rng[1]);
                norm_size.z = norm_size.x / (rng[0] / rng[2]);
            } else if (mn == sy) {
                norm_size.x = norm_size.y / (rng[1] / rng[0]);
                norm_size.z = norm_size.y / (rng[1] / rng[2]);
            } else {
                norm_size.x = norm_size.z / (rng[2] / rng[0]);
                norm_size.y = norm_size.z / (rng[2] / rng[1]);
            }
        }
        for (auto& v : verts) {
            V3 t = {
                norm_size.x * ((v.x - vmin.x) / rng[0] - 0.5f),
                norm_size.y * ((v.y - vmin.y) / rng[1] - 0.5f),
                norm_size.z * ((v.z - vmin.z) / rng[2] - 0.5f),
            };
            t = rot_row(t, rmat9);
            t.x += pos.x; t.y += pos.y; t.z += pos.z;
            if (rng[0] < bias) t.x = pos.x;
            if (rng[1] < bias) t.y = pos.y;
            if (rng[2] < bias) t.z = pos.z;
            v = t;
        }
        for (auto& n : normals) n = rot_row(n, rmat9);
        V3 rs = rot_row(norm_size, rmat9);
        rs = {std::fabs(rs.x), std::fabs(rs.y), std::fabs(rs.z)};
        res->root_bounds[0] = pos.x - rs.x / 2;
        res->root_bounds[1] = pos.y - rs.y / 2;
        res->root_bounds[2] = pos.z - rs.z / 2;
        res->root_bounds[3] = pos.x + rs.x / 2;
        res->root_bounds[4] = pos.y + rs.y / 2;
        res->root_bounds[5] = pos.z + rs.z / 2;
    };

    // Token-bounded float parse mirroring the Python loader's
    // np.float32(parts[k]): each of the first `n` whitespace tokens
    // must be a FULLY-numeric float literal (trailing junk like "3x"
    // and hex forms raise ValueError in Python -> parse error here,
    // so the dispatch falls back to Python and re-raises); missing
    // tokens are Python's IndexError; EXTRA tokens are ignored.
    auto parse_floats = [](const char* p, float* out, int n) -> bool {
        for (int k = 0; k < n; k++) {
            while (*p == ' ' || *p == '\t') p++;
            if (!*p) return false;  // missing token
            const char* tok_end = p;
            while (*tok_end && *tok_end != ' ' && *tok_end != '\t')
                tok_end++;
            // Python float() rejects hex literals and NaN payload
            // forms ("nan(1)") that strtof accepts.
            for (const char* q = p; q < tok_end; q++)
                if (*q == 'x' || *q == 'X' || *q == '(') return false;
            char* endp = nullptr;
            out[k] = std::strtof(p, &endp);
            if (endp != tok_end) return false;  // partial/garbage token
            p = tok_end;
        }
        return true;
    };

    char linebuf[4096];
    while (std::fgets(linebuf, sizeof(linebuf), f)) {
        char* line = linebuf;
        // strip trailing CR/LF and comments
        if (char* hash = std::strchr(line, '#')) *hash = 0;
        size_t len = std::strlen(line);
        while (len && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            line[--len] = 0;
        if (!len) continue;

        // header token (%n: offset PAST the token — `line +
        // strlen(head)` would land inside any leading whitespace and
        // silently drop the line, diverging from the Python loader's
        // split()).
        char head[32] = {0};
        int head_end = 0;
        if (std::sscanf(line, "%31s%n", head, &head_end) != 1) continue;
        const char* rest = line + head_end;
        while (*rest == ' ' || *rest == '\t') rest++;

        if (!std::strcmp(head, "v")) {
            float c3[3];
            if (!parse_floats(rest, c3, 3)) {
                // Python raises (IndexError/ValueError) on malformed
                // vertex lines; silently skipping would shift every
                // later face index -> corrupt geometry.
                std::fclose(f);
                delete res;
                return nullptr;
            }
            float x = c3[0], y = c3[1], z = c3[2];
            if (!normalized) {
                // np.minimum/maximum.reduce semantics (the Python
                // loader's first-face bounds): NaN coordinates
                // propagate into the bounds; plain if-comparisons
                // would silently ignore them and build a divergent
                // mesh transform.
                auto nmin = [](float a, float b) {
                    return (a != a || b != b) ? NAN : (b < a ? b : a);
                };
                auto nmax = [](float a, float b) {
                    return (a != a || b != b) ? NAN : (b > a ? b : a);
                };
                vmin.x = nmin(vmin.x, x);
                vmin.y = nmin(vmin.y, y);
                vmin.z = nmin(vmin.z, z);
                vmax.x = nmax(vmax.x, x);
                vmax.y = nmax(vmax.y, y);
                vmax.z = nmax(vmax.z, z);
            }
            verts.push_back({x, y, z});  // raw if after first face
        } else if (!std::strcmp(head, "vn")) {
            float c3[3];
            if (!parse_floats(rest, c3, 3)) {
                std::fclose(f);
                delete res;
                return nullptr;
            }
            V3 n = vnorm({c3[0], c3[1], c3[2]});
            normals.push_back(n);  // raw if after first face
        } else if (!std::strcmp(head, "vt")) {
            float c2[2];
            if (!parse_floats(rest, c2, 2)) {
                std::fclose(f);
                delete res;
                return nullptr;
            }
            uvs.push_back({c2[0], c2[1]});
        } else if (!std::strcmp(head, "f")) {
            if (!normalized) apply_first_face();
            int slash_count = 0;
            for (const char* p = line; *p; p++)
                if (*p == '/') slash_count++;
            std::vector<int64_t> vi, ti, ni;
            if (slash_count == 0) {
                const char* p = rest;
                while (*p) {
                    while (*p == ' ' || *p == '\t') p++;
                    if (!*p) break;
                    char* endp = nullptr;
                    int64_t a = std::strtoll(p, &endp, 10);
                    if (endp == p) {
                        // Non-numeric token: the Python loader raises
                        // ValueError (int(tok)); strtoll would not
                        // advance, so continuing would loop forever.
                        std::fclose(f);
                        delete res;
                        return nullptr;
                    }
                    p = endp;
                    vi.push_back(a);
                }
            } else if (slash_count % 2 == 0) {
                // Parse WITHIN each whitespace-delimited token, like
                // the Python loader's tok.split("/"): a bare strtoll
                // walk would skip whitespace mid-field and read the
                // NEXT token's vertex index as this token's normal
                // ("f 1// 2// 3//" silently lost all its triangles).
                const char* p = rest;
                bool bad = false;
                while (*p && !bad) {
                    while (*p == ' ' || *p == '\t') p++;
                    if (!*p) break;
                    const char* tok_end = p;
                    while (*tok_end && *tok_end != ' ' && *tok_end != '\t')
                        tok_end++;
                    // fields[k]: int(field) if non-empty else 0; a
                    // non-numeric field raises in Python (int()).
                    // Fields past the third are ignored UNVALIDATED
                    // (Python only indexes fields[0..2]).
                    int64_t fld[3] = {0, 0, 0};
                    const char* q = p;
                    for (int k = 0; k < 3; k++) {
                        const char* fend = q;
                        while (fend < tok_end && *fend != '/') fend++;
                        if (fend > q) {
                            char* endp = nullptr;
                            fld[k] = std::strtoll(q, &endp, 10);
                            if (endp != fend) { bad = true; break; }
                        }
                        if (fend >= tok_end) break;
                        q = fend + 1;
                    }
                    if (bad) break;
                    if (fld[0] > 0) {
                        vi.push_back(fld[0]);
                        if (fld[1] > 0) ti.push_back(fld[1]);
                        if (fld[2] > 0) ni.push_back(fld[2]);
                    }
                    p = tok_end;
                }
                if (bad) {
                    std::fclose(f);
                    delete res;
                    return nullptr;
                }
            } else {
                continue;  // unhandled slash count (objects.cpp:378)
            }
            bool has_n = !ni.empty();
            bool has_t = !ti.empty() && has_n;
            // Mixed per-token formats can leave ni/ti shorter than vi;
            // the Python loader's ni[i+1]/ti[i+1] raises IndexError
            // there — reading past the vector here would be UB.
            if ((has_n && ni.size() < vi.size()) ||
                (has_t && ti.size() < vi.size())) {
                std::fclose(f);
                delete res;
                return nullptr;
            }
            for (size_t i = 1; i + 1 < vi.size(); i++) {
                fv.push_back(vi[0] - 1);
                fv.push_back(vi[i] - 1);
                fv.push_back(vi[i + 1] - 1);
                if (has_n) {
                    fn.push_back(ni[0] - 1);
                    fn.push_back(ni[i] - 1);
                    fn.push_back(ni[i + 1] - 1);
                } else {
                    fn.push_back(-1); fn.push_back(-1); fn.push_back(-1);
                }
                if (has_t) {
                    ft.push_back(ti[0] - 1);
                    ft.push_back(ti[i] - 1);
                    ft.push_back(ti[i + 1] - 1);
                } else {
                    ft.push_back(-1); ft.push_back(-1); ft.push_back(-1);
                }
            }
        }
    }
    std::fclose(f);

    int64_t T = (int64_t)fv.size() / 3;
    res->n_tris = T;
    res->v.resize(T * 9);
    res->n.resize(T * 9);
    res->uv.resize(T * 6);
    res->tangent.resize(T * 3);
    res->bitangent.resize(T * 3);

    // Index semantics of the Python loader's numpy gathers: indices in
    // [-len, len) are valid (negatives wrap), anything else raises —
    // we return nullptr so the wrapper falls back to that error.
    auto wrap_idx = [](int64_t a, size_t len) -> int64_t {
        if (a < -(int64_t)len || a >= (int64_t)len) return -1;
        return a < 0 ? a + (int64_t)len : a;
    };
    for (int64_t t = 0; t < T; t++) {
        V3 tv[3];
        for (int k = 0; k < 3; k++) {
            int64_t idx = wrap_idx(fv[t * 3 + k], verts.size());
            if (idx < 0) {
                delete res;
                return nullptr;
            }
            fv[t * 3 + k] = idx;
            tv[k] = verts[(size_t)fv[t * 3 + k]];
            res->v[t * 9 + k * 3 + 0] = tv[k].x;
            res->v[t * 9 + k * 3 + 1] = tv[k].y;
            res->v[t * 9 + k * 3 + 2] = tv[k].z;
        }
        // normals: explicit or unnormalized face cross product
        if (fn[t * 3] >= 0) {
            for (int k = 0; k < 3; k++) {
                if (fn[t * 3 + k] >= (int64_t)normals.size()) {
                    delete res;
                    return nullptr;
                }
                const V3& n = normals[(size_t)fn[t * 3 + k]];
                res->n[t * 9 + k * 3 + 0] = n.x;
                res->n[t * 9 + k * 3 + 1] = n.y;
                res->n[t * 9 + k * 3 + 2] = n.z;
            }
        } else {
            V3 e1 = {tv[1].x - tv[0].x, tv[1].y - tv[0].y, tv[1].z - tv[0].z};
            V3 e2 = {tv[2].x - tv[0].x, tv[2].y - tv[0].y, tv[2].z - tv[0].z};
            V3 cr = {e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
                     e1.x * e2.y - e1.y * e2.x};
            for (int k = 0; k < 3; k++) {
                res->n[t * 9 + k * 3 + 0] = cr.x;
                res->n[t * 9 + k * 3 + 1] = cr.y;
                res->n[t * 9 + k * 3 + 2] = cr.z;
            }
        }
        bool has_uv = ft[t * 3] >= 0;
        V2 tuv[3] = {{0, 0}, {0, 0}, {0, 0}};
        if (has_uv) {
            for (int k = 0; k < 3; k++) {
                if (ft[t * 3 + k] >= (int64_t)uvs.size()) {
                    delete res;
                    return nullptr;
                }
                tuv[k] = uvs[(size_t)ft[t * 3 + k]];
            }
        }
        for (int k = 0; k < 3; k++) {
            res->uv[t * 6 + k * 2 + 0] = tuv[k].u;
            res->uv[t * 6 + k * 2 + 1] = tuv[k].v;
        }
        if (has_uv) {
            V3 e1 = {tv[1].x - tv[0].x, tv[1].y - tv[0].y, tv[1].z - tv[0].z};
            V3 e2 = {tv[2].x - tv[0].x, tv[2].y - tv[0].y, tv[2].z - tv[0].z};
            float du1 = tuv[1].u - tuv[0].u, dv1 = tuv[1].v - tuv[0].v;
            float du2 = tuv[2].u - tuv[0].u, dv2 = tuv[2].v - tuv[0].v;
            float fcoef = 1.0f / (du1 * dv2 - du2 * dv1);
            res->tangent[t * 3 + 0] = fcoef * (dv2 * e1.x - dv1 * e2.x);
            res->tangent[t * 3 + 1] = fcoef * (dv2 * e1.y - dv1 * e2.y);
            res->tangent[t * 3 + 2] = fcoef * (dv2 * e1.z - dv1 * e2.z);
            res->bitangent[t * 3 + 0] = fcoef * (-du2 * e1.x + du1 * e2.x);
            res->bitangent[t * 3 + 1] = fcoef * (-du2 * e1.y + du1 * e2.y);
            res->bitangent[t * 3 + 2] = fcoef * (-du2 * e1.z + du1 * e2.z);
        } else {
            for (int k = 0; k < 3; k++) {
                res->tangent[t * 3 + k] = 0;
                res->bitangent[t * 3 + k] = 0;
            }
        }
    }
    return res;
}

int64_t rtn_mesh_ntris(void* h) { return ((MeshResult*)h)->n_tris; }

void rtn_mesh_copy(void* h, float* v, float* n, float* uv, float* tangent,
                   float* bitangent, float* bounds) {
    auto* m = (MeshResult*)h;
    std::memcpy(v, m->v.data(), m->v.size() * 4);
    std::memcpy(n, m->n.data(), m->n.size() * 4);
    std::memcpy(uv, m->uv.data(), m->uv.size() * 4);
    std::memcpy(tangent, m->tangent.data(), m->tangent.size() * 4);
    std::memcpy(bitangent, m->bitangent.data(), m->bitangent.size() * 4);
    std::memcpy(bounds, m->root_bounds, 6 * 4);
}

void rtn_mesh_free(void* h) { delete (MeshResult*)h; }

// ------------------------------ SAH BVH ------------------------------

namespace {

struct BuildCtx {
    const float* tmin;  // T*3 per-tri min coords
    const float* tmax;  // T*3
    int ac_penalty;
    int leaf_chunk;
    BvhResult* out;
    int64_t real_nodes = 1;
    int64_t tri_copies = 0;
};

struct BuildNode {
    float bmin[3], bmax[3];
    std::vector<int64_t> tris;  // empty + children set => inner
    BuildNode* left = nullptr;
    BuildNode* right = nullptr;
    bool is_leaf = false;
    ~BuildNode() { delete left; delete right; }
};

float calc_sah(const BuildCtx& c, int axis, const std::vector<int64_t>& idx,
               float b0, float b1, float boundary) {
    int64_t nl = 0, nr = 0;
    for (int64_t t : idx) {
        if (c.tmin[t * 3 + axis] <= boundary) nl++;
        if (c.tmax[t * 3 + axis] >= boundary) nr++;
    }
    return (float)nl * (boundary - b0) + (float)nr * (b1 - boundary);
}

float search_sah(const BuildCtx& c, int axis, const std::vector<int64_t>& idx,
                 float b0, float b1) {
    float left = b0, right = b1;
    for (;;) {
        float mid = right - (right - left) / 2.0f;
        if (right - left < 0.1f) return mid;
        if (calc_sah(c, axis, idx, b0, b1, mid - 0.05f)
            < calc_sah(c, axis, idx, b0, b1, mid + 0.05f))
            right = mid;
        else
            left = mid;
    }
}

void setup(BuildCtx& c, BuildNode* node, std::vector<int64_t>& idx, int depth) {
    if ((int64_t)idx.size() <= (int64_t)depth * c.ac_penalty) {
        node->is_leaf = true;
        node->tris = std::move(idx);
        c.tri_copies += node->tris.size();
        return;
    }
    float dim[3] = {node->bmax[0] - node->bmin[0],
                    node->bmax[1] - node->bmin[1],
                    node->bmax[2] - node->bmin[2]};
    int axis;
    if (dim[0] > dim[1] && dim[0] > dim[2]) axis = 0;
    else if (dim[1] > dim[2]) axis = 1;
    else axis = 2;
    float b0 = node->bmin[axis], b1 = node->bmax[axis];
    float split = search_sah(c, axis, idx, b0, b1);
    std::vector<int64_t> li, ri;
    for (int64_t t : idx) {
        if (c.tmin[t * 3 + axis] <= split) li.push_back(t);
        if (c.tmax[t * 3 + axis] >= split) ri.push_back(t);
    }
    if (li.empty() || ri.empty()
        || (double)(li.size() + ri.size()) >= (double)idx.size() * 1.5) {
        node->is_leaf = true;
        node->tris = std::move(idx);
        c.tri_copies += node->tris.size();
        return;
    }
    node->left = new BuildNode();
    node->right = new BuildNode();
    std::memcpy(node->left->bmin, node->bmin, 12);
    std::memcpy(node->left->bmax, node->bmax, 12);
    node->left->bmax[axis] = split;
    std::memcpy(node->right->bmin, node->bmin, 12);
    std::memcpy(node->right->bmax, node->bmax, 12);
    node->right->bmin[axis] = split;
    c.real_nodes += 2;
    idx.clear();
    idx.shrink_to_fit();
    setup(c, node->right, ri, depth + 1);
    setup(c, node->left, li, depth + 1);
}

void emit(BuildCtx& c, BuildNode* node) {
    BvhResult* o = c.out;
    if (node->is_leaf) {
        int64_t n_tris = (int64_t)node->tris.size();
        for (int64_t t : node->tris) {
            for (int k = 0; k < 3; k++) {
                float& lo = o->reach_lo[t * 3 + k];
                float& hi = o->reach_hi[t * 3 + k];
                if (node->bmin[k] < lo) lo = node->bmin[k];
                if (node->bmax[k] > hi) hi = node->bmax[k];
            }
        }
        int64_t n_chunks = n_tris > 0 ? (n_tris + c.leaf_chunk - 1) / c.leaf_chunk : 1;
        int64_t first = (int64_t)o->skip.size();
        for (int64_t ch = 0; ch < n_chunks; ch++) {
            int64_t s = ch * c.leaf_chunk;
            int64_t e = std::min<int64_t>(s + c.leaf_chunk, n_tris);
            for (int k = 0; k < 3; k++) {
                o->node_min.push_back(node->bmin[k]);
                o->node_max.push_back(node->bmax[k]);
            }
            o->leaf_start.push_back((int32_t)o->leaf_tris.size());
            o->leaf_count.push_back((int32_t)(e - s));
            o->real_flag.push_back(ch == 0 ? 1 : 0);
            for (int64_t t = s; t < e; t++)
                o->leaf_tris.push_back((int32_t)node->tris[t]);
            o->skip.push_back(-1);
        }
        int32_t after = (int32_t)o->skip.size();
        for (int64_t i = first; i < after; i++) o->skip[i] = after;
    } else {
        int64_t i = (int64_t)o->skip.size();
        for (int k = 0; k < 3; k++) {
            o->node_min.push_back(node->bmin[k]);
            o->node_max.push_back(node->bmax[k]);
        }
        o->leaf_start.push_back(0);
        o->leaf_count.push_back(0);
        o->real_flag.push_back(1);
        o->skip.push_back(-1);
        emit(c, node->left);
        emit(c, node->right);
        o->skip[i] = (int32_t)o->skip.size();
    }
}

}  // namespace

void* rtn_build_bvh(const float* tri_v, int64_t T, const float* bounds6,
                    int ac_penalty, int leaf_chunk) {
    auto* out = new BvhResult();
    out->reach_lo.assign(T * 3, FLT_MAX);
    out->reach_hi.assign(T * 3, -FLT_MAX);
    std::vector<float> tmin(T * 3), tmax(T * 3);
    for (int64_t t = 0; t < T; t++) {
        for (int k = 0; k < 3; k++) {
            float a = tri_v[t * 9 + 0 + k];
            float b = tri_v[t * 9 + 3 + k];
            float c = tri_v[t * 9 + 6 + k];
            float mn = a < b ? a : b; mn = c < mn ? c : mn;
            float mx = a > b ? a : b; mx = c > mx ? c : mx;
            tmin[t * 3 + k] = mn;
            tmax[t * 3 + k] = mx;
        }
    }
    BuildCtx ctx{tmin.data(), tmax.data(), ac_penalty, leaf_chunk, out};
    BuildNode root;
    std::memcpy(root.bmin, bounds6, 12);
    std::memcpy(root.bmax, bounds6 + 3, 12);
    std::vector<int64_t> idx(T);
    for (int64_t t = 0; t < T; t++) idx[t] = t;
    if (T > 0) setup(ctx, &root, idx, 1);
    else { root.is_leaf = true; }
    emit(ctx, &root);
    for (int k = 0; k < leaf_chunk; k++) out->leaf_tris.push_back(0);  // pad
    out->n_real_nodes = ctx.real_nodes;
    out->tri_copies = ctx.tri_copies;
    return out;
}

void rtn_bvh_sizes(void* h, int64_t* n_nodes, int64_t* n_leaf_tris,
                   int64_t* n_real, int64_t* tri_copies, int64_t* n_tris) {
    auto* b = (BvhResult*)h;
    *n_nodes = (int64_t)b->skip.size();
    *n_leaf_tris = (int64_t)b->leaf_tris.size();
    *n_real = b->n_real_nodes;
    *tri_copies = b->tri_copies;
    *n_tris = (int64_t)b->reach_lo.size() / 3;
}

void rtn_bvh_copy(void* h, float* node_min, float* node_max, int32_t* skip,
                  int32_t* leaf_start, int32_t* leaf_count, int32_t* real_flag,
                  int32_t* leaf_tris, float* reach_lo, float* reach_hi) {
    auto* b = (BvhResult*)h;
    std::memcpy(node_min, b->node_min.data(), b->node_min.size() * 4);
    std::memcpy(node_max, b->node_max.data(), b->node_max.size() * 4);
    std::memcpy(skip, b->skip.data(), b->skip.size() * 4);
    std::memcpy(leaf_start, b->leaf_start.data(), b->leaf_start.size() * 4);
    std::memcpy(leaf_count, b->leaf_count.data(), b->leaf_count.size() * 4);
    std::memcpy(real_flag, b->real_flag.data(), b->real_flag.size() * 4);
    std::memcpy(leaf_tris, b->leaf_tris.data(), b->leaf_tris.size() * 4);
    std::memcpy(reach_lo, b->reach_lo.data(), b->reach_lo.size() * 4);
    std::memcpy(reach_hi, b->reach_hi.data(), b->reach_hi.size() * 4);
}

void rtn_bvh_free(void* h) { delete (BvhResult*)h; }

}  // extern "C"
