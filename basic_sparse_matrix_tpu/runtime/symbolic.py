"""Host symbolic analysis: ctypes bindings over the native C++ runtime.

Builds ``native/csparse.cpp`` with g++ on first use (cached as a .so next to
the source, named by the source's content hash so an edited source rebuilds
and an unchanged one never does) and falls back to equivalent pure-numpy
implementations when a toolchain is unavailable. These produce the static
schedules (fill patterns, level sets) that the device numeric phases consume — the division of labour the
reference crate doesn't have because it interleaves symbolic and numeric work
in scalar loops (e.g. ``cholesky_decomp``'s get_row_complete-per-k,
``/root/reference/src/sparse.rs:687-712``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "csparse.cpp")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_I64 = ctypes.POINTER(ctypes.c_int64)


def so_path() -> str:
    """Path of the shared library built from the current source."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, "native", f"csparse-{digest}.so")


def _build() -> Optional[ctypes.CDLL]:
    try:
        so = so_path()
        if not os.path.exists(so):
            # Build under a per-process name, then rename: concurrent first
            # users (test workers) never load a half-written library.
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, nscalars, nptrs in [
            ("coo_to_csr_perm", 2, 4), ("etree", 1, 3),
            ("chol_row_counts", 1, 4), ("chol_pattern", 1, 5),
            ("level_sets", 1, 3), ("postorder", 1, 2),
            ("chol_update_triples", 1, 3), # + 1 scalar + 4 ptrs appended below
        ]:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_int64] * nscalars + [_I64] * nptrs
        lib.chol_update_triples.argtypes = (
            [ctypes.c_int64] + [_I64] * 3 + [ctypes.c_int64] + [_I64] * 4
        )
        # round-2 natives (mixed scalar/pointer signatures)
        _i = ctypes.c_int64
        for name, argtypes in [
            ("rcm_ordering", [_i, _I64, _I64, _I64]),
            ("supernodes_relaxed", [_i, _I64, _I64, _I64, _i, _I64]),
            ("expand_pattern", [_i, _I64, _I64, _I64, _I64, _i, _I64, _I64]),
            ("nd_ordering", [_i, _I64, _I64, _i, _I64]),
        ]:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = argtypes
        return lib
    except Exception:
        return None


def native_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _build() or False  # False = tried and failed
    return _lib or None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I64)


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


# --------------------------------------------------------------------------- #
# Elimination tree
# --------------------------------------------------------------------------- #
def etree(n: int, indptr, indices) -> np.ndarray:
    """Elimination tree from the strictly-lower CSR pattern of a symmetric
    matrix. ``parent[i] == -1`` marks roots."""
    indptr, indices = _c64(indptr), _c64(indices)
    parent = np.empty(n, dtype=np.int64)
    lib = native_lib()
    if lib is not None:
        lib.etree(n, _ptr(indptr), _ptr(indices), _ptr(parent))
        return parent
    # numpy/python fallback (Liu's algorithm with path compression)
    parent[:] = -1
    ancestor = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            k = indices[p]
            while k != -1 and k < i:
                nxt = ancestor[k]
                ancestor[k] = i
                if nxt == -1:
                    parent[k] = i
                k = nxt
    return parent


# --------------------------------------------------------------------------- #
# Symbolic Cholesky fill pattern
# --------------------------------------------------------------------------- #
def chol_symbolic(n: int, indptr, indices) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Full symbolic factorization: returns (parent, l_indptr, l_indices)
    where (l_indptr, l_indices) is the row-wise CSR pattern of L including
    the diagonal (sorted, diagonal last in each row)."""
    indptr, indices = _c64(indptr), _c64(indices)
    parent = etree(n, indptr, indices)
    lib = native_lib()
    counts = np.empty(n, dtype=np.int64)
    if lib is not None:
        lib.chol_row_counts(n, _ptr(indptr), _ptr(indices), _ptr(parent),
                            _ptr(counts))
        l_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=l_indptr[1:])
        l_indices = np.empty(int(l_indptr[-1]), dtype=np.int64)
        lib.chol_pattern(n, _ptr(indptr), _ptr(indices), _ptr(parent),
                         _ptr(l_indptr), _ptr(l_indices))
        return parent, l_indptr, l_indices
    # fallback
    mark = np.full(n, -1, dtype=np.int64)
    rows = []
    for i in range(n):
        row = []
        mark[i] = i
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            while j != -1 and j < i and mark[j] != i:
                mark[j] = i
                row.append(j)
                j = parent[j]
        row.sort()
        row.append(i)
        rows.append(row)
    counts = np.array([len(r) for r in rows], dtype=np.int64)
    l_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=l_indptr[1:])
    l_indices = np.concatenate([np.asarray(r, dtype=np.int64) for r in rows])
    return parent, l_indptr, l_indices


# --------------------------------------------------------------------------- #
# Level sets for triangular solves
# --------------------------------------------------------------------------- #
def level_sets(n: int, indptr, indices) -> Tuple[np.ndarray, int]:
    """Dependency levels for a lower-triangular solve on pattern (indptr,
    indices): rows in the same level are independent and solve in one batched
    device step. Returns (level per row, number of levels)."""
    indptr, indices = _c64(indptr), _c64(indices)
    level = np.zeros(n, dtype=np.int64)
    lib = native_lib()
    if lib is not None:
        nlev = int(lib.level_sets(n, _ptr(indptr), _ptr(indices),
                                  _ptr(level)))
        return level, nlev
    nlev = 0
    for i in range(n):
        lv = 0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j < i:
                lv = max(lv, level[j] + 1)
        level[i] = lv
        nlev = max(nlev, lv + 1)
    return level, nlev


def postorder(parent: np.ndarray) -> np.ndarray:
    parent = _c64(parent)
    n = parent.shape[0]
    post = np.empty(n, dtype=np.int64)
    lib = native_lib()
    if lib is not None:
        lib.postorder(n, _ptr(parent), _ptr(post))
        return post
    # fallback: iterative DFS
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        p = parent[i]
        if p != -1:
            nxt[i] = head[p]
            head[p] = i
    out = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack = [root]
        while stack:
            node = stack[-1]
            child = head[node]
            if child != -1:
                head[node] = nxt[child]
                stack.append(child)
            else:
                stack.pop()
                out.append(node)
    return np.asarray(out, dtype=np.int64)


def coo_to_csr_perm(n_rows: int, rows, cols) -> Tuple[np.ndarray, np.ndarray]:
    """Native counting-sort COO→CSR permutation: returns (indptr, perm) such
    that applying ``perm`` to the triplet arrays yields row-major sorted
    order. Fallback: numpy lexsort."""
    rows, cols = _c64(rows), _c64(cols)
    nnz = rows.shape[0]
    lib = native_lib()
    if lib is not None:
        indptr = np.empty(n_rows + 1, dtype=np.int64)
        perm = np.empty(nnz, dtype=np.int64)
        lib.coo_to_csr_perm(n_rows, nnz, _ptr(rows), _ptr(cols),
                            _ptr(indptr), _ptr(perm))
        return indptr, perm
    perm = np.lexsort((cols, rows))
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr[1:], rows, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, perm


def chol_update_triples(col_ptr, row_idx, level, nlev: int):
    """Numeric-phase scatter lists for left-looking Cholesky: per-level
    (dst, src_a, src_b) position triples into L's CSC value array (native
    two-phase; O(flops)). Returns (dst, a, b, level_of_triple) flat arrays
    sorted by level. Incomplete patterns are handled (out-of-pattern
    destinations skipped)."""
    col_ptr, row_idx, level = _c64(col_ptr), _c64(row_idx), _c64(level)
    n = col_ptr.shape[0] - 1
    lib = native_lib()
    if lib is not None:
        counts = np.zeros(nlev, dtype=np.int64)
        total = int(lib.chol_update_triples(
            n, _ptr(col_ptr), _ptr(row_idx), _ptr(level), 1, _ptr(counts),
            None, None, None))
        offsets = np.zeros(nlev, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        starts = offsets.copy()
        dst = np.empty(total, dtype=np.int64)
        a = np.empty(total, dtype=np.int64)
        b = np.empty(total, dtype=np.int64)
        lib.chol_update_triples(
            n, _ptr(col_ptr), _ptr(row_idx), _ptr(level), 0, _ptr(offsets),
            _ptr(dst), _ptr(a), _ptr(b))
        lvl_of = np.repeat(np.arange(nlev, dtype=np.int64), counts)
        return dst, a, b, lvl_of, counts, starts
    # python fallback (same merge algorithm)
    dst_l, a_l, b_l, lvl_l = [], [], [], []
    for k in range(n):
        lo, hi = int(col_ptr[k]) + 1, int(col_ptr[k + 1])
        for p in range(lo, hi):
            j = int(row_idx[p])
            lv = int(level[j])
            jp, jhi = int(col_ptr[j]), int(col_ptr[j + 1])
            for q in range(p, hi):
                i = int(row_idx[q])
                while jp < jhi and row_idx[jp] < i:
                    jp += 1
                if jp >= jhi:
                    break
                if row_idx[jp] != i:
                    continue
                dst_l.append(jp)
                a_l.append(q)
                b_l.append(p)
                lvl_l.append(lv)
    order = np.argsort(np.asarray(lvl_l, dtype=np.int64), kind="stable")         if lvl_l else np.empty(0, dtype=np.int64)
    dst = np.asarray(dst_l, dtype=np.int64)[order]
    a = np.asarray(a_l, dtype=np.int64)[order]
    b = np.asarray(b_l, dtype=np.int64)[order]
    lvl_of = np.asarray(lvl_l, dtype=np.int64)[order]
    counts = np.bincount(lvl_of, minlength=nlev).astype(np.int64)
    starts = np.zeros(nlev, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return dst, a, b, lvl_of, counts, starts


def supernodes(col_ptr, row_idx, parent, *, relax: int = 0) -> np.ndarray:
    """Fundamental supernode partition of a Cholesky factor pattern.

    Columns j and j+1 belong to one supernode when j+1 is j's etree parent
    and column j's below-diagonal structure equals column j+1's structure
    plus the diagonal — i.e. the dense panels of a supernodal factorization.
    ``relax`` allows amalgamating when the structures differ by at most that
    many rows (relaxed supernodes: more padding, fewer and wider panels).

    Returns ``super_id`` per column (non-decreasing). Groundwork for the
    supernodal numeric phase (dense panel matmuls instead of scatter-list
    updates).
    """
    col_ptr, row_idx, parent = _c64(col_ptr), _c64(row_idx), _c64(parent)
    n = col_ptr.shape[0] - 1
    super_id = np.zeros(n, dtype=np.int64)
    lib = native_lib()
    if lib is not None and n:
        lib.supernodes_relaxed(n, _ptr(col_ptr), _ptr(row_idx), _ptr(parent),
                               int(relax), _ptr(super_id))
        return super_id
    sid = 0
    budget = relax  # extra-row budget PER SUPERNODE, not per pair
    for j in range(1, n):
        mergeable = parent[j - 1] == j
        if mergeable:
            # fundamental condition: below-diag struct(j-1) minus {j} must
            # equal below-diag struct(j); `relax` grants a per-supernode
            # budget of tolerated structure mismatches (relaxed
            # amalgamation — the budget bounds total padding per panel)
            prev_below = set(
                row_idx[col_ptr[j - 1] + 1 : col_ptr[j]].tolist()) - {j}
            cur_below = set(
                row_idx[col_ptr[j] + 1 : col_ptr[j + 1]].tolist())
            diff = len(prev_below ^ cur_below)
            if diff > budget:
                mergeable = False
            else:
                budget -= diff
        if not mergeable:
            sid += 1
            budget = relax
        super_id[j] = sid
    return super_id


def rcm_ordering(n: int, indptr, indices) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of a symmetric pattern (pass the full
    symmetric CSR adjacency). Returns ``perm`` such that ``A[perm][:, perm]``
    has reduced bandwidth — improving gather locality for SpMM and reducing
    Cholesky fill (classic preprocessing the reference has no equivalent
    for)."""
    indptr, indices = _c64(indptr), _c64(indices)
    lib = native_lib()
    if lib is not None:
        perm = np.empty(n, dtype=np.int64)
        lib.rcm_ordering(n, _ptr(indptr), _ptr(indices), _ptr(perm))
        return perm
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # BFS from minimum-degree start nodes, neighbours sorted by degree
    for start_candidate in np.argsort(degree, kind="stable"):
        if visited[start_candidate]:
            continue
        queue = [int(start_candidate)]
        visited[start_candidate] = True
        while queue:
            node = queue.pop(0)
            order[pos] = node
            pos += 1
            nbrs = indices[indptr[node]:indptr[node + 1]]
            nbrs = [int(x) for x in nbrs if not visited[x] and x != node]
            nbrs.sort(key=lambda x: degree[x])
            for x in nbrs:
                visited[x] = True
            queue.extend(nbrs)
    return order[::-1].copy()  # reverse CM


def nd_ordering(n: int, indptr, indices, *, leaf: int = 64) -> np.ndarray:
    """Nested-dissection ordering by recursive BFS bisection (pass the full
    symmetric CSR adjacency). Separators are eliminated last, keeping
    Cholesky fill O(n log n)-ish on grid-like patterns where RCM's profile
    ordering stops helping — the standard preprocessing for the 2D/3D
    Laplacians this project benchmarks. Deterministic; native C++ with an
    identical Python fallback."""
    indptr, indices = _c64(indptr), _c64(indices)
    lib = native_lib()
    if lib is not None:
        perm = np.empty(n, dtype=np.int64)
        filled = int(lib.nd_ordering(n, _ptr(indptr), _ptr(indices),
                                     int(leaf), _ptr(perm)))
        assert filled == n
        return perm
    # Python fallback — mirrors csparse.cpp nd_ordering exactly.
    out = np.empty(n, dtype=np.int64)
    pos = 0

    def bfs(verts_set, root):
        level = {root: 0}
        order = [root]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for p in range(indptr[u], indptr[u + 1]):
                x = int(indices[p])
                if x == u or x not in verts_set or x in level:
                    continue
                level[x] = level[u] + 1
                order.append(x)
        return level, order

    # connected components, ascending-vertex order
    seen = np.zeros(n, dtype=bool)
    comps = []
    for v0 in range(n):
        if seen[v0]:
            continue
        comp = [v0]
        seen[v0] = True
        head = 0
        while head < len(comp):
            u = comp[head]
            head += 1
            for p in range(indptr[u], indptr[u + 1]):
                x = int(indices[p])
                if x != u and not seen[x]:
                    seen[x] = True
                    comp.append(x)
        comps.append(sorted(comp))
    stack = [(c, False) for c in reversed(comps)]
    while stack:
        verts, emit = stack.pop()
        if emit or len(verts) <= leaf:
            out[pos: pos + len(verts)] = verts
            pos += len(verts)
            continue
        vset = set(verts)
        _, order1 = bfs(vset, verts[0])
        level, order2 = bfs(vset, order1[-1])
        if len(order2) != len(verts) or level[order2[-1]] == 0:
            vs = sorted(verts)
            out[pos: pos + len(vs)] = vs
            pos += len(vs)
            continue
        mid = level[order2[len(order2) // 2]]
        max_level = level[order2[-1]]
        # mirror csparse.cpp exactly (sequential clamps; a depth-1 structure
        # yields mid 0: empty A, root as separator)
        if mid == 0:
            mid = 1
        if mid == max_level:
            mid = max_level - 1
        a = sorted(v for v in verts if level[v] < mid)
        b = sorted(v for v in verts if level[v] > mid)
        s = sorted(v for v in verts if level[v] == mid)
        stack.append((s, True))
        stack.append((b, False))
        stack.append((a, False))
    assert pos == n
    return out


def expand_pattern(n: int, col_ptr, row_idx, c0, c1):
    """Relaxed-amalgamation pattern expansion: every column of a supernode
    takes the union below-row structure of its panel plus its in-panel tail
    (explicit zeros), restoring the fundamental property by construction.
    Returns (new_col_ptr, new_row_idx), rows sorted ascending per column."""
    col_ptr, row_idx = _c64(col_ptr), _c64(row_idx)
    c0, c1 = _c64(c0), _c64(c1)
    n = int(n)
    nsn = c0.shape[0]
    lib = native_lib()
    if lib is not None:
        counts = np.zeros(n, dtype=np.int64)
        total = int(lib.expand_pattern(nsn, _ptr(col_ptr), _ptr(row_idx),
                                       _ptr(c0), _ptr(c1), 1, _ptr(counts),
                                       None))
        new_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=new_ptr[1:])
        new_rows = np.empty(total, dtype=np.int64)
        offsets = new_ptr[:-1].copy()
        lib.expand_pattern(nsn, _ptr(col_ptr), _ptr(row_idx), _ptr(c0),
                           _ptr(c1), 0, _ptr(offsets), _ptr(new_rows))
        return new_ptr, new_rows
    # numpy fallback (same construction, vectorised per supernode)
    new_cols_list, new_rows_list = [], []
    for s in range(nsn):
        lo, hi = int(c0[s]), int(c1[s])
        u = np.unique(row_idx[col_ptr[lo]:col_ptr[hi]])
        below_u = u[u >= hi]
        for j in range(lo, hi):
            rows_j = np.concatenate(
                [np.arange(j, hi, dtype=np.int64), below_u])
            new_rows_list.append(rows_j)
            new_cols_list.append(np.full(rows_j.size, j, dtype=np.int64))
    rows_flat = np.concatenate(new_rows_list) if new_rows_list else \
        np.empty(0, dtype=np.int64)
    cols_flat = np.concatenate(new_cols_list) if new_cols_list else \
        np.empty(0, dtype=np.int64)
    order = np.lexsort((rows_flat, cols_flat))
    rows_flat, cols_flat = rows_flat[order], cols_flat[order]
    new_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(new_ptr[1:], cols_flat, 1)
    new_ptr = np.cumsum(new_ptr)
    return new_ptr, rows_flat


def chol_symbolic_csr(a) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full symbolic factorization of a CSR instance's lower pattern,
    memoised on the instance — one ``chol_symbolic`` per matrix no matter
    how many of {supernode_stats, analyze_supernodal, cholesky_sparse's
    analyze} run in a solve pipeline."""
    cache = getattr(a, "_chol_sym_cache", None)
    if cache is not None:
        return cache
    n = a.rows
    indptr, indices, _ = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    low = indices < rows
    low_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(low_indptr[1:], rows[low], 1)
    low_indptr = np.cumsum(low_indptr)
    cache = chol_symbolic(n, low_indptr, indices[low])
    object.__setattr__(a, "_chol_sym_cache", cache)
    return cache
