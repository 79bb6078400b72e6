"""Molecular integrals over cartesian Gaussians (McMurchie-Davidson scheme).

A numpy copy of ``deepqmc_tpu/pretrain/integrals.py``, the one- and
two-electron integrals of the in-house SCF baseline, with its own Boys
function in place of ``scipy.special.hyp1f1``: the port does not depend on
scipy.  The angular normalization matches :class:`.gto.GTOBasis` exactly, so
SCF orbital coefficients apply directly to its AO values.
"""

import math

import numpy as np

__all__ = ['IntegralEngine']


def cartesian_angulars(l: int):
    return [
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    ]


def double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def primitive_norm(l_xyz, zeta: float) -> float:
    """Normalization of a cartesian primitive, matching GTOShell's convention."""
    lx, ly, lz = l_xyz
    l = lx + ly + lz
    anorm = 1.0 / np.sqrt(
        double_factorial(2 * lx - 1)
        * double_factorial(2 * ly - 1)
        * double_factorial(2 * lz - 1)
    )
    rnorm = (2 * zeta / np.pi) ** 0.75 * (4 * zeta) ** (l / 2)
    return anorm * rnorm


def hermite_coefs(i: int, j: int, t: int, Qx: float, a: float, b: float) -> float:
    """Hermite expansion coefficient E_t^{ij} (recursive)."""
    p = a + b
    q = a * b / p
    if t < 0 or t > i + j:
        return 0.0
    if i == j == t == 0:
        return np.exp(-q * Qx * Qx)
    if j == 0:
        return (
            hermite_coefs(i - 1, j, t - 1, Qx, a, b) / (2 * p)
            - q * Qx / a * hermite_coefs(i - 1, j, t, Qx, a, b)
            + (t + 1) * hermite_coefs(i - 1, j, t + 1, Qx, a, b)
        )
    return (
        hermite_coefs(i, j - 1, t - 1, Qx, a, b) / (2 * p)
        + q * Qx / b * hermite_coefs(i, j - 1, t, Qx, a, b)
        + (t + 1) * hermite_coefs(i, j - 1, t + 1, Qx, a, b)
    )


# Below this T (or 2m) the Boys function is summed as a series, above it
# computed from erf by upward recursion, which is stable once T > m
BOYS_SERIES_MAX_T = 30.0
_erf = np.frompyfunc(math.erf, 1, 1)


def _boys_series(m, T):
    """F_m(T) = exp(-T) sum_k (2T)^k / ((2m+1)(2m+3)...(2m+2k+1)): positive
    terms, so no cancellation; summed until the terms are below rounding."""
    term = 1.0 / (2 * m + 1)
    total = term.copy()
    k = 0
    while np.any(term > 1e-17 * total):
        k += 1
        term = term * (2 * T) / (2 * m + 2 * k + 1)
        total = total + term
    return np.exp(-T) * total


def _boys_recursion(m, T):
    """F_0(T) = sqrt(pi / T) erf(sqrt(T)) / 2, then
    F_{n+1} = ((2n + 1) F_n - exp(-T)) / (2T) up to each entry's m."""
    f = 0.5 * np.sqrt(np.pi / T) * _erf(np.sqrt(T)).astype(float)
    exp_t = np.exp(-T)
    out = f.copy()
    for n in range(int(m.max(initial=0))):
        f = ((2 * n + 1) * f - exp_t) / (2 * T)
        out = np.where(m == n + 1, f, out)
    return out


def boys(m, T):
    """The Boys function F_m(T) = int_0^1 t^(2m) exp(-T t^2) dt, elementwise
    over ``m`` and ``T`` broadcast (``hyp1f1(m + 1/2, m + 3/2, -T) / (2m + 1)``)."""
    m, T = np.broadcast_arrays(np.asarray(m, dtype=float), np.asarray(T, dtype=float))
    out = np.empty(m.shape)
    series = T < np.maximum(BOYS_SERIES_MAX_T, 2 * m)
    if series.any():
        out[series] = _boys_series(m[series], T[series])
    if not series.all():
        out[~series] = _boys_recursion(m[~series], T[~series])
    return out[()]


def hermite_coulomb(t, u, v, n, p, PC):
    """Hermite Coulomb integral R^n_{tuv} (recursive)."""
    x, y, z = PC
    if t == u == v == 0:
        return (-2.0 * p) ** n * boys(n, p * (x * x + y * y + z * z))
    if t > 0:
        val = x * hermite_coulomb(t - 1, u, v, n + 1, p, PC)
        if t > 1:
            val += (t - 1) * hermite_coulomb(t - 2, u, v, n + 1, p, PC)
        return val
    if u > 0:
        val = y * hermite_coulomb(t, u - 1, v, n + 1, p, PC)
        if u > 1:
            val += (u - 1) * hermite_coulomb(t, u - 2, v, n + 1, p, PC)
        return val
    val = z * hermite_coulomb(t, u, v - 1, n + 1, p, PC)
    if v > 1:
        val += (v - 1) * hermite_coulomb(t, u, v - 2, n + 1, p, PC)
    return val


class _Primitive:
    __slots__ = ('center', 'l_xyz', 'zeta', 'coef')

    def __init__(self, center, l_xyz, zeta, coef):
        self.center = np.asarray(center, float)
        self.l_xyz = l_xyz
        self.zeta = float(zeta)
        self.coef = float(coef)  # contraction coefficient x normalization


class IntegralEngine:
    """One-/two-electron integrals for a basis given as (atom, (l, c, z)) shells."""

    def __init__(self, centers, shells):
        centers = np.asarray(centers, float)
        self.basis: list[list[_Primitive]] = []  # per AO: list of primitives
        for atom_idx, (l, coeffs, zetas) in shells:
            for l_xyz in cartesian_angulars(l):
                prims = [
                    _Primitive(
                        centers[atom_idx],
                        l_xyz,
                        zeta,
                        coef * primitive_norm(l_xyz, zeta),
                    )
                    for coef, zeta in zip(coeffs, zetas)
                ]
                self.basis.append(prims)
        self.n_ao = len(self.basis)

    # --- primitive-level kernels ------------------------------------------

    @staticmethod
    def _overlap_prim(a: _Primitive, b: _Primitive) -> float:
        p = a.zeta + b.zeta
        AB = a.center - b.center
        s = (np.pi / p) ** 1.5
        for d in range(3):
            s *= hermite_coefs(
                a.l_xyz[d], b.l_xyz[d], 0, AB[d], a.zeta, b.zeta
            )
        return s

    @classmethod
    def _kinetic_prim(cls, a: _Primitive, b: _Primitive) -> float:
        beta = b.zeta
        lx, ly, lz = b.l_xyz

        def s_shift(d, dl):
            l_new = list(b.l_xyz)
            l_new[d] += dl
            if l_new[d] < 0:
                return 0.0
            b_new = _Primitive(b.center, tuple(l_new), b.zeta, 1.0)
            return cls._overlap_prim(a, b_new)

        term = 0.0
        for d, l_d in enumerate(b.l_xyz):
            term += (
                -2 * beta**2 * s_shift(d, 2)
                + beta * (2 * l_d + 1) * s_shift(d, 0)
                - 0.5 * l_d * (l_d - 1) * s_shift(d, -2)
            )
        return term

    @staticmethod
    def _nuclear_prim(a: _Primitive, b: _Primitive, C, Z: float) -> float:
        p = a.zeta + b.zeta
        P = (a.zeta * a.center + b.zeta * b.center) / p
        AB = a.center - b.center
        PC = P - np.asarray(C, float)
        la, lb = a.l_xyz, b.l_xyz
        val = 0.0
        for t in range(la[0] + lb[0] + 1):
            Ex = hermite_coefs(la[0], lb[0], t, AB[0], a.zeta, b.zeta)
            if Ex == 0.0:
                continue
            for u in range(la[1] + lb[1] + 1):
                Ey = hermite_coefs(la[1], lb[1], u, AB[1], a.zeta, b.zeta)
                if Ey == 0.0:
                    continue
                for v in range(la[2] + lb[2] + 1):
                    Ez = hermite_coefs(la[2], lb[2], v, AB[2], a.zeta, b.zeta)
                    if Ez == 0.0:
                        continue
                    val += Ex * Ey * Ez * hermite_coulomb(t, u, v, 0, p, PC)
        return -Z * 2 * np.pi / p * val

    # --- matrix assembly ---------------------------------------------------

    def _one_electron(self, kernel) -> np.ndarray:
        n = self.n_ao
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1):
                val = 0.0
                for pa in self.basis[i]:
                    for pb in self.basis[j]:
                        val += pa.coef * pb.coef * kernel(pa, pb)
                out[i, j] = out[j, i] = val
        return out

    def overlap(self) -> np.ndarray:
        return self._one_electron(self._overlap_prim)

    def kinetic(self) -> np.ndarray:
        n = self.n_ao
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                val = 0.0
                for pa in self.basis[i]:
                    for pb in self.basis[j]:
                        val += pa.coef * pb.coef * self._kinetic_prim(pa, pb)
                out[i, j] = val
        return 0.5 * (out + out.T)

    def nuclear(self, centers, charges) -> np.ndarray:
        def kernel(pa, pb):
            return sum(
                self._nuclear_prim(pa, pb, C, Z)
                for C, Z in zip(np.asarray(centers), np.asarray(charges))
            )

        return self._one_electron(kernel)

    def _pair_hermite_cube(self, pa: _Primitive, pb: _Primitive, L: int):
        """Hermite expansion of a primitive pair as a dense (L+1)^3 cube."""
        p = pa.zeta + pb.zeta
        P = (pa.zeta * pa.center + pb.zeta * pb.center) / p
        AB = pa.center - pb.center
        la, lb = pa.l_xyz, pb.l_xyz
        cube = np.zeros((L + 1, L + 1, L + 1))
        ex = [
            hermite_coefs(la[0], lb[0], t, AB[0], pa.zeta, pb.zeta)
            for t in range(la[0] + lb[0] + 1)
        ]
        ey = [
            hermite_coefs(la[1], lb[1], u, AB[1], pa.zeta, pb.zeta)
            for u in range(la[1] + lb[1] + 1)
        ]
        ez = [
            hermite_coefs(la[2], lb[2], v, AB[2], pa.zeta, pb.zeta)
            for v in range(la[2] + lb[2] + 1)
        ]
        cube[: len(ex), : len(ey), : len(ez)] = (
            np.asarray(ex)[:, None, None]
            * np.asarray(ey)[None, :, None]
            * np.asarray(ez)[None, None, :]
        )
        return p, P, cube

    @staticmethod
    def _r_tables(N: int, alpha: np.ndarray, PQ: np.ndarray) -> np.ndarray:
        """Vectorized Hermite-Coulomb tables R^0_{tuv} for a quartet batch.

        Returns [batch, N+1, N+1, N+1]; entries with t+u+v > N are unused.
        """
        B = alpha.shape[0]
        T = alpha * (PQ**2).sum(axis=1)
        ms = np.arange(N + 1)
        F = boys(ms[None, :], T[:, None])  # [B, N+1]
        scale = (-2.0 * alpha)[:, None] ** ms[None, :]
        base = scale * F  # R^n_{000}
        # DP downward in n: R_prev holds R^{n+1}_{tuv}, levels grow each step
        tables = {(0, 0, 0): base[:, N]}
        for n in range(N - 1, -1, -1):
            new = {(0, 0, 0): base[:, n]}
            max_l = N - n
            for t in range(max_l + 1):
                for u in range(max_l - t + 1):
                    for v in range(max_l - t - u + 1):
                        if t == u == v == 0:
                            continue
                        if t > 0:
                            val = PQ[:, 0] * tables.get(
                                (t - 1, u, v), 0.0
                            )
                            if t > 1:
                                val = val + (t - 1) * tables.get(
                                    (t - 2, u, v), 0.0
                                )
                        elif u > 0:
                            val = PQ[:, 1] * tables.get((t, u - 1, v), 0.0)
                            if u > 1:
                                val = val + (u - 1) * tables.get(
                                    (t, u - 2, v), 0.0
                                )
                        else:
                            val = PQ[:, 2] * tables.get((t, u, v - 1), 0.0)
                            if v > 1:
                                val = val + (v - 1) * tables.get(
                                    (t, u, v - 2), 0.0
                                )
                        new[(t, u, v)] = val
            tables = new
        out = np.zeros((B, N + 1, N + 1, N + 1))
        for (t, u, v), val in tables.items():
            out[:, t, u, v] = val
        return out

    @classmethod
    def _schwarz_bounds(cls, entries) -> np.ndarray:
        """Cauchy-Schwarz bound sqrt((e|e)) per primitive-pair entry.

        (ab|cd) <= Q_ab Q_cd, so entries with a tiny Q cannot contribute:
        tight same-shell primitives on different atoms carry an
        exp(-mu |AB|^2) factor in their Hermite cube and screen out, which
        is what makes large-molecule ERI assembly tractable.  Batched per
        total-angular-momentum class (one Boys/Hermite table call per L).
        """
        qs = np.empty(len(entries))
        by_L: dict[int, list[int]] = {}
        for k, e in enumerate(entries):
            by_L.setdefault(e[1], []).append(k)
        for L, idxs in by_L.items():
            coef = np.array([entries[k][2] for k in idxs])
            p = np.array([entries[k][3] for k in idxs])
            E = np.array([entries[k][5] for k in idxs])  # [m, L+1]^3
            R = cls._r_tables(2 * L, p / 2.0, np.zeros((len(idxs), 3)))
            sgn = (-1.0) ** (
                np.add.outer(
                    np.add.outer(np.arange(L + 1), np.arange(L + 1)),
                    np.arange(L + 1),
                )
            )
            Es = E * sgn
            acc = np.zeros(len(idxs))
            for t in range(L + 1):
                for u in range(L + 1 - t):
                    for v in range(L + 1 - t - u):
                        window = R[
                            :, t : t + L + 1, u : u + L + 1, v : v + L + 1
                        ]
                        acc += E[:, t, u, v] * np.einsum(
                            'mTUV,mTUV->m', Es, window, optimize=True
                        )
            pref = 2 * np.pi**2.5 / (p * p * np.sqrt(2 * p)) * coef**2
            qs[idxs] = np.sqrt(np.abs(pref * acc))
        return qs

    def eri(self, chunk_size: int = 20000, screen_tol: float = 1e-10) -> np.ndarray:
        """Full (ij|kl) tensor in chemists' notation (batched assembly)."""
        n = self.n_ao
        # enumerate AO pairs (i >= j) and their primitive-pair Hermite cubes
        ao_pairs = [(i, j) for i in range(n) for j in range(i + 1)]
        pair_idx_of = {pair: k for k, pair in enumerate(ao_pairs)}
        n_pairs = len(ao_pairs)
        entries = []  # (pair_idx, L, coef, p, P, cube)
        for (i, j) in ao_pairs:
            for pa in self.basis[i]:
                for pb in self.basis[j]:
                    L = sum(pa.l_xyz) + sum(pb.l_xyz)
                    p, P, cube = self._pair_hermite_cube(pa, pb, L)
                    entries.append(
                        (pair_idx_of[(i, j)], L, pa.coef * pb.coef, p, P, cube)
                    )
        if screen_tol:
            q = self._schwarz_bounds(entries)
            keep = q > screen_tol * max(q.max(), 1e-300)
            entries = [e for e, k in zip(entries, keep) if k]
        # group primitive-pair entries by total bra angular momentum
        by_L: dict[int, dict[str, np.ndarray]] = {}
        for L in sorted({e[1] for e in entries}):
            sel = [e for e in entries if e[1] == L]
            by_L[L] = {
                'pair': np.array([e[0] for e in sel]),
                'coef': np.array([e[2] for e in sel]),
                'p': np.array([e[3] for e in sel]),
                'P': np.array([e[4] for e in sel]),
                'E': np.array([e[5] for e in sel]),  # [m, L+1, L+1, L+1]
            }
        V = np.zeros((n_pairs, n_pairs))
        for L1, g1 in by_L.items():
            for L2, g2 in by_L.items():
                if L2 < L1:
                    continue
                N = L1 + L2
                m1, m2 = len(g1['pair']), len(g2['pair'])
                # sign factor (-1)^(t'+u'+v') folded into the ket cubes
                sgn = (-1.0) ** (
                    np.add.outer(
                        np.add.outer(np.arange(L2 + 1), np.arange(L2 + 1)),
                        np.arange(L2 + 1),
                    )
                )
                E2s = g2['E'] * sgn
                # chunk so the R workspace stays ~chunk_size KILO-elements:
                # rows must not degenerate to 1 for large L groups (the
                # per-iteration numpy overhead would dominate)
                rows = max(1, 1000 * chunk_size // max(m2 * (N + 1) ** 3, 1))
                for start in range(0, m1, rows):
                    sl = slice(start, min(start + rows, m1))
                    c1, p1, P1, E1 = (
                        g1['coef'][sl],
                        g1['p'][sl],
                        g1['P'][sl],
                        g1['E'][sl],
                    )
                    b1 = len(c1)
                    alpha = (p1[:, None] * g2['p'][None]) / (
                        p1[:, None] + g2['p'][None]
                    )
                    PQ = P1[:, None, :] - g2['P'][None, :, :]
                    pref = (
                        2
                        * np.pi**2.5
                        / (
                            p1[:, None]
                            * g2['p'][None]
                            * np.sqrt(p1[:, None] + g2['p'][None])
                        )
                        * c1[:, None]
                        * g2['coef'][None]
                    )
                    R = self._r_tables(
                        N, alpha.reshape(-1), PQ.reshape(-1, 3)
                    ).reshape(b1, m2, N + 1, N + 1, N + 1)
                    # contract sum_tuv E1 sum_t'u'v' E2 R_{t+t',u+u',v+v'},
                    # slicing R windows per bra index to avoid an 8-D array
                    vals = np.zeros((b1, m2))
                    for t in range(L1 + 1):
                        for u in range(L1 + 1 - t):
                            for v in range(L1 + 1 - t - u):
                                e1 = E1[:, t, u, v]
                                if not e1.any():
                                    continue
                                window = R[
                                    :,
                                    :,
                                    t : t + L2 + 1,
                                    u : u + L2 + 1,
                                    v : v + L2 + 1,
                                ]
                                vals += e1[:, None] * np.einsum(
                                    'bTUV,abTUV->ab', E2s, window, optimize=True
                                )
                    vals = pref * vals
                    np.add.at(V, (g1['pair'][sl][:, None], g2['pair'][None]), vals)
                    if L2 > L1:
                        np.add.at(
                            V, (g2['pair'][None], g1['pair'][sl][:, None]), vals
                        )
        if len(by_L) == 1:
            # only one L class: the symmetric (L2 == L1) block covered both
            # orders already via the full m1 x m2 product
            pass
        eri = np.zeros((n, n, n, n))
        I = np.array([p[0] for p in ao_pairs])
        J = np.array([p[1] for p in ao_pairs])
        for bra in ((I, J), (J, I)):
            for ket in ((I, J), (J, I)):
                eri[
                    bra[0][:, None], bra[1][:, None], ket[0][None], ket[1][None]
                ] = V
        return eri
