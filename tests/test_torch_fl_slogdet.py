"""The port's forward-Laplacian flat log-determinant against the JAX package.

``slogdet_fl_flat_split`` (the CPU path: ``torch.linalg`` for the primal and
the plain traces ``slogdet_traces_plain``) is held to JAX
``slogdet_fl_flat_split`` and to the Pallas kernel
``_pallas_blocked_flat_split`` in interpret mode, on the same seeded inputs,
at float64.  Relative tolerance 1e-10: the same algebra, with LU-based
inverses on both sides, separated by float64 rounding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepqmc_tpu.ops.fl_slogdet import _pallas_blocked_flat_split
from deepqmc_tpu.ops.fl_slogdet import slogdet_fl_flat_split as jax_flat_split
from deepqmc_tpu_torch.ops import fl_slogdet

B, NU, ND, D, K = 3, 2, 2, 3, 12
N = NU + ND
RTOL = 1e-10


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    # well-conditioned determinants: identity blocks plus noise
    a = np.tile(np.eye(N), (1, D))[None] + 0.5 * rng.normal(size=(B, N, D * N))
    ju = rng.normal(size=(B, K, NU, D * N))
    jd = rng.normal(size=(B, K, ND, D * N))
    la = rng.normal(size=(B, N, D * N))
    return a, ju, jd, la


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize('seed', [0, 1])
def test_flat_split_matches_jax_twin(seed):
    args = _inputs(seed)
    want = jax.vmap(lambda *t: jax_flat_split(*t, D))(*map(jnp.asarray, args))
    got = fl_slogdet.slogdet_fl_flat_split(*(torch.as_tensor(x) for x in args), D)
    _close([g.numpy() for g in got], want)


def test_flat_split_matches_interpret_mode_kernel():
    args = _inputs(2)
    want = _pallas_blocked_flat_split(*map(jnp.asarray, args), D, interpret=True)
    got = fl_slogdet.slogdet_fl_flat_split(*(torch.as_tensor(x) for x in args), D)
    _close([g.numpy() for g in got], want)


def test_plain_traces_match_explicit_products():
    """jout and trq of the plain version against a loop over (walker, k, det)."""
    a, ju, jd, _ = (torch.as_tensor(x) for x in _inputs(3))
    inv = torch.linalg.inv(a.unflatten(-1, (D, N)).movedim(-2, -3))
    jout, trq = fl_slogdet.slogdet_traces_plain(inv, ju, jd)
    j = torch.cat([ju, jd], dim=2)
    for b in range(B):
        for d in range(D):
            q = 0.0
            for k in range(K):
                m = inv[b, d] @ j[b, k, :, d * N:(d + 1) * N]
                assert torch.allclose(jout[b, k, d], torch.trace(m), rtol=RTOL)
                q = q + torch.trace(m @ m)
            assert torch.allclose(trq[b, d], q, rtol=RTOL)


def test_wrapper_takes_plain_version_on_cpu():
    a, ju, jd, _ = (torch.as_tensor(x) for x in _inputs(4))
    inv = torch.linalg.inv(a.unflatten(-1, (D, N)).movedim(-2, -3))
    before = fl_slogdet.slogdet_traces.launches
    got = fl_slogdet.slogdet_traces(inv, ju, jd)
    want = fl_slogdet.slogdet_traces_plain(inv, ju, jd)
    assert fl_slogdet.slogdet_traces.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'layout'])
def test_kernel_input_checks_reject(fault):
    a, ju, jd, _ = (torch.as_tensor(x, dtype=torch.float32) for x in _inputs(5))
    inv = torch.linalg.inv(a.unflatten(-1, (D, N)).movedim(-2, -3)).contiguous()
    fl_slogdet.validate(inv, ju, jd)
    if fault == 'dtype':
        ju = ju.double()
    elif fault == 'shape':
        jd = jd[..., :-1]
    else:
        inv = inv.transpose(-1, -2)
    with pytest.raises((TypeError, ValueError)):
        fl_slogdet.validate(inv, ju, jd)


def _flat_smem_bytes(n, G, S):
    """Bytes of the flat kernel's shared-memory plan (``staged_layout`` of
    ``csrc/fl_slogdet.cu`` with the flat stage): S stages of n rows by G n
    columns (rounded up to 4), A^-1 transposed (above 16 electrons), the rows
    of m with one column of padding, and an 8-byte mbarrier a stage."""
    gn = G * n
    floats = S * n * ((gn + 3) // 4 * 4) + (n * gn if n > 16 else 0) + gn * (n + 1)
    return 4 * ((floats + 1) // 2 * 2 + 2 * S)


@pytest.mark.parametrize('case, B, D, n, want', [
    ('H2O, all determinants a block', 2048, 16, 10, 16),
    ('benzene, 2 of 42 rows a block', 256, 16, 42, 2),
    ('n = 48, one a block to fill the card', 64, 4, 48, 1),
    ('few walkers, one a block', 5, 3, 7, 1),
])
def test_flat_plan_groups(case, B, D, n, want):
    """Determinants a block of the flat kernel on an H100 (132 SMs, 227 KB a block)."""
    assert fl_slogdet.flat_plan(B, D, n, 132, 232448, _flat_smem_bytes) == want


def test_flat_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match='shared memory'):
        fl_slogdet.flat_plan(64, 4, 48, 132, 30_000, _flat_smem_bytes)


# --- the two bodies' plans and the layout record (csrc/fl_slogdet.cu) -----------

LIMIT = 232448  # an H100 block's opt-in shared memory


def _up4(x):
    return -(-x // 4) * 4


def _staged_smem_bytes(n, G, S, stage):
    """Bytes of the staged body's plan (``staged_layout``): S stages, A^-1
    transposed above 16 electrons, the rows of m with one column of padding,
    an 8-byte mbarrier a stage."""
    floats = S * stage + (n * G * n if n > 16 else 0) + G * n * (n + 1)
    return 4 * ((floats + 1) // 2 * 2 + 2 * S)


def _tiled_smem_bytes(n, S, stage):
    """Bytes of the tiled body's plan (``tiled_layout``): A^-1 transposed [n][np],
    S stages and 4 floats of slack, the tiles of m twice [np][64], m's diagonal
    twice [np], 8 warp sums, an 8-byte mbarrier a stage."""
    np_ = _up4(n)
    return 4 * (n * np_ + S * stage + 4 + 2 * np_ * 64 + 2 * np_ + 8 + 2 * S)


def _tile_at(r, col):
    """``tile_at``: where m[r][col] lies in the tiles' exchange array (floats)."""
    return r * 64 + 4 * ((col >> 2) ^ (r // 4 % 8)) + (col & 3)


def _tile_col(vec, tj, q, nt):
    """``tile_col``: column q of thread tj's tile."""
    return 2 * tj + (q & 1) + (q >> 1) * 2 * nt if vec == 2 else 4 * tj + q


def _vec(layout, n):
    """The tiled instance a layout takes at n: rows of the stage 16-, 8- or
    4-byte aligned (flat rows are padded to 4 floats)."""
    s_row = _up4(n) if layout == fl_slogdet.FLAT else n
    return 4 if s_row % 4 == 0 else 2 if s_row % 2 == 0 else 1


def _wavefronts(addresses, width):
    """Shared-memory wavefronts of one warp access, each thread's ``width``
    floats from its address (4-byte words): served in phases of 32, 16 or 8
    threads for 4-, 8- or 16-byte accesses, each phase as many wavefronts as
    the most distinct words one of the 32 banks holds."""
    per = 32 // width
    total = 0
    for p0 in range(0, len(addresses), per):
        banks = {}
        for a in addresses[p0:p0 + per]:
            for w in range(a, a + width):
                banks.setdefault(w % 32, set()).add(w)
        total += max(len(v) for v in banks.values())
    return total


@pytest.mark.parametrize('n', [17, 33, 42, 48, 64])
def test_tile_mapping_and_bank_conflicts(n):
    """Every thread's columns and the exchange array's places are one to one,
    and a warp's loads of a row of J take one wavefront a phase of threads (no
    bank conflict) with a row's floats two at a time (8-byte aligned rows), and
    with four at a time where 16 tiles fill a row (n = 64)."""
    nt = _up4(n) // 4
    for vec in (4, 2, 1):
        cols = sorted(_tile_col(vec, tj, q, nt) for tj in range(nt) for q in range(4))
        assert cols == list(range(4 * nt))
    places = [_tile_at(r, c) for r in range(4 * nt) for c in range(4 * nt)]
    assert len(set(places)) == len(places)
    assert all(r * 64 <= _tile_at(r, c) < (r + 1) * 64
               for r in range(4 * nt) for c in range(4 * nt))
    threads = [(t // nt, t % nt) for t in range(nt * nt)]
    loads = {4: [0], 2: [0, 2]}  # the first column of each load
    for vec in (4, 2) if nt == 16 else (2,):
        for w0 in range(0, len(threads), 32):
            warp = threads[w0:w0 + 32]
            for q in loads[vec]:  # one load of a row of J
                addresses = [_tile_col(vec, tj, q, nt) for _, tj in warp]
                assert _wavefronts(addresses, vec) == -(-len(warp) * vec // 32)
def _smem_bytes(body, n, G, S, stage):
    return (_tiled_smem_bytes(n, S, stage) if body == fl_slogdet.TILED
            else _staged_smem_bytes(n, G, S, stage))


LAYOUTS = {'flat': fl_slogdet.FLAT, 'square': fl_slogdet.SQUARE,
           'square_split': fl_slogdet.SQUARE_SPLIT}


def _rows(layout, n):
    """(nu, nd) of a layout at n: the square layout is one block."""
    return (n, 0) if layout == fl_slogdet.SQUARE else (-(-n // 2), n // 2)


def test_staged_layout_of_the_flat_kernel_is_unchanged():
    """The staged body's plan with the flat record is kernel 2's plan before the
    bodies were shared: ``_flat_smem_bytes`` for every group and ring."""
    for D, n in ((16, 10), (16, 42), (4, 48), (3, 7), (4, 2)):
        for G in (g for g in range(1, D + 1) if D % g == 0):
            rb = fl_slogdet.row_blocks(fl_slogdet.FLAT, D, -(-n // 2), n // 2, G)
            for S in (2, 3, 4):
                assert _staged_smem_bytes(n, G, S, rb.stage) == _flat_smem_bytes(n, G, S)


@pytest.mark.parametrize('body', ['staged', 'tiled'])
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_plans_fit_a_block(layout, body):
    """For D in {1, 3, 4, 16} and n in {2, 5, 10, 16, 42, 64} (the staged body
    up to its largest instance, 48), the plan's group divides D and fits the
    block's threads, its ring is one the body takes, and its shared memory fits
    an H100 block."""
    lay, bd = LAYOUTS[layout], getattr(fl_slogdet, body.upper())
    for D in (1, 3, 4, 16):
        for n in (2, 5, 10, 16, 42, 64):
            if bd == fl_slogdet.STAGED and n > fl_slogdet.STAGED_MAX_N:
                continue
            nu, nd = _rows(lay, n)
            for B in (5, 256, 2048):
                p = fl_slogdet.plan(lay, bd, B, D, nu, nd, 132, LIMIT, _smem_bytes)
                assert p.body == bd and D % p.G == 0
                if bd == fl_slogdet.STAGED:
                    assert p.G * n <= fl_slogdet.FLAT_MAX_THREADS
                    assert p.S == fl_slogdet.FLAT_STAGES
                else:
                    assert p.G == 1 and p.S in fl_slogdet.TILED_STAGES
                    assert fl_slogdet.tiled_threads(n) <= 256
                stage = fl_slogdet.row_blocks(lay, D, nu, nd, p.G).stage
                assert _smem_bytes(bd, n, p.G, p.S, stage) <= LIMIT


@pytest.mark.parametrize('case, layout, body, B, D, n, want', [
    ('H2O, all determinants a block', 'square', 'staged', 2048, 16, 10, (16, 3)),
    ('H2O split, all determinants a block', 'square_split', 'staged', 2048, 16, 10, (16, 3)),
    ('benzene square: a ring of 3 costs a block', 'square', 'tiled', 256, 16, 42, (1, 2)),
    ('benzene split', 'square_split', 'tiled', 256, 16, 42, (1, 2)),
    ('benzene flat', 'flat', 'tiled', 256, 16, 42, (1, 2)),
    ('n = 64: two blocks an SM, the deepest ring that keeps them', 'square', 'tiled',
     64, 4, 64, (1, 4)),
    ('n = 64 flat', 'flat', 'tiled', 64, 4, 64, (1, 4)),
])
def test_plan_choices(case, layout, body, B, D, n, want):
    """(G, S) on an H100 (132 SMs, 227 KB a block, 228 KB an SM) at the main
    path's and the large-n shapes of chip_smoke.py."""
    lay = LAYOUTS[layout]
    p = fl_slogdet.plan(lay, getattr(fl_slogdet, body.upper()), B, D, *_rows(lay, n), 132,
                        LIMIT, _smem_bytes)
    assert (p.G, p.S) == want
    assert fl_slogdet.tiled_threads(n) == {10: 32, 42: 128, 64: 256}[n]


def test_tiled_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match='shared memory'):
        fl_slogdet.plan(fl_slogdet.SQUARE, fl_slogdet.TILED, 64, 4, 64, 0, 132, 30_000,
                        _smem_bytes)


def _global(layout, ja, nu):
    """The flat memory of the Jacobian operands a layout reads, from ja [B, K, D, n, n]:
    (up buffer, down buffer)."""
    def flat(j):  # [B, K, D, rows, n] -> [B, K, rows, D*n]
        return np.ascontiguousarray(np.swapaxes(j, 2, 3)).reshape(-1)

    up, dn = ja[..., :nu, :], ja[..., nu:, :]
    if layout == fl_slogdet.FLAT:
        return flat(up), flat(dn)
    return np.ascontiguousarray(up).reshape(-1), np.ascontiguousarray(dn).reshape(-1)


def _fill_stage(layout, rb, up, dn, b, k, d0, K, G, nu, nd, base=0):
    """A stage as the kernel's copies fill it (``issue_stage``) from the flat
    buffers, whose first float lies ``base`` floats past a 16-byte boundary,
    NaN where no copy writes, with the 4 floats of slack the tiled body keeps
    after its ring; (stage, the up and the down run's shift).  Each TMA copy
    is checked for 16-byte alignment at both ends and a 16-byte multiple."""
    n = nu + nd
    gn = G * n
    stage = np.full(rb.stage + 4, np.nan)
    written = np.zeros(rb.stage, dtype=int)
    src_up = (b * K + k) * rb.up_bk + d0 * rb.up_d
    src_dn = (b * K + k) * rb.dn_bk + d0 * rb.dn_d
    shifts = [0, 0]
    if rb.shift:  # each run at its shift: the interior by TMA, the ends plain
        ends = (rb.s_dn, rb.stage)
        for j, (dst, buf, src, length) in enumerate(((0, up, src_up, gn * nu),
                                                     (rb.s_dn, dn, src_dn, gn * nd))):
            if not length:
                continue
            sh = shifts[j] = (base + src) % 4
            head = min((4 - sh) % 4, length)
            inner = (length - head) // 4 * 4
            assert (dst + sh + head) % 4 == 0 and (base + src + head) % 4 == 0
            assert dst + sh + length <= ends[j]
            stage[dst + sh:dst + sh + length] = buf[src:src + length]
            written[dst + sh:dst + sh + length] += 1
    else:
        if rb.runs:
            copies = [(0, up, src_up, gn * nu)] + ([(rb.s_dn, dn, src_dn, gn * nd)] if nd else [])
        else:
            copies = [(r * rb.s_row, up, src_up + r * rb.row, gn) for r in range(nu)]
            copies += [(rb.s_dn + r * rb.s_row, dn, src_dn + r * rb.row, gn) for r in range(nd)]
        for dst, buf, src, length in copies:
            assert dst % rb.vw == 0 and (base + src) % rb.vw == 0 and length % rb.vw == 0
            stage[dst:dst + length] = buf[src:src + length]
            written[dst:dst + length] += 1
    assert written.max() == 1 and written.sum() == G * n * n
    return stage, shifts


def _row(rb, stage, g, r, nu, width, shifts=(0, 0)):
    """Determinant g's row r in the stage, ``width`` floats from its start."""
    at = (g * rb.s_up_d + r * rb.s_row + shifts[0] if r < nu
          else rb.s_dn + g * rb.s_dn_d + (r - nu) * rb.s_row + shifts[1])
    return stage[at:at + width]


@pytest.mark.parametrize('layout, D, nu, nd, G', [
    ('flat', 16, 5, 5, 16),  # H2O: one run each for the up and the down rows
    ('flat', 16, 5, 5, 4),  # a group of the determinants: a copy a row
    ('flat', 3, 3, 2, 3),  # rows of 15 floats, padded in the stage to 16: a copy a row
    ('flat', 16, 21, 21, 1),  # the tiled body's one determinant
    ('flat', 4, 2, 0, 4),  # no down rows
    ('square', 16, 10, 0, 16),
    ('square', 16, 10, 0, 8),
    ('square', 3, 5, 0, 3),  # 75 floats a run: 4-byte copies
    ('square', 16, 42, 0, 1),
    ('square_split', 16, 5, 5, 16),
    ('square_split', 4, 2, 0, 4),  # no down rows (triplet H2)
    ('square_split', 3, 3, 2, 1),
    ('square_split', 16, 21, 21, 1),  # runs of 882 floats: 8-byte copies
    ('square_split', 4, 32, 32, 1),
])
def test_layout_record_places_every_row(layout, D, nu, nd, G):
    """The stage filled as the record's copies say holds determinant g's row r
    where the record says, for every group of a walker and direction, equal to
    ja[b, k, d0 + g, r]."""
    n, B, K = nu + nd, 2, 3
    lay = LAYOUTS[layout]
    ja = np.random.default_rng(n + G).normal(size=(B, K, D, n, n))
    up, dn = _global(lay, ja, nu)
    for base in (0, 1, 2, 3):  # the pointers' offset past a 16-byte boundary, in floats
        rb = fl_slogdet.row_blocks(lay, D, nu, nd, G, align={0: 16, 2: 8}.get(base, 4))
        for b in range(B):
            for k in range(K):
                for d0 in range(0, D, G):
                    stage, shifts = _fill_stage(lay, rb, up, dn, b, k, d0, K, G, nu, nd, base)
                    for g in range(G):
                        for r in range(n):
                            np.testing.assert_array_equal(_row(rb, stage, g, r, nu, n, shifts),
                                                          ja[b, k, d0 + g, r])


def test_copy_width_follows_alignment():
    """TMA (4 floats a copy) where every start and length is a multiple of 16
    bytes and the pointers are 16-byte aligned; else 8- or 4-byte copies, or,
    for a square layout whose (walker, direction) strides are multiples of 4
    floats, TMA for each run's aligned interior at the run's shift.  The
    record carries the pointers' alignment, which bounds the rows' float
    width."""
    def record(layout, D, nu, nd, G, align=16):
        rb = fl_slogdet.row_blocks(layout, D, nu, nd, G, align=align)
        return rb.vw, rb.shift, rb.align

    assert record(fl_slogdet.FLAT, 16, 5, 5, 16) == (4, 0, 4)
    assert record(fl_slogdet.FLAT, 16, 5, 5, 16, align=8) == (2, 0, 2)
    assert record(fl_slogdet.FLAT, 16, 21, 21, 1) == (2, 0, 4)
    assert record(fl_slogdet.FLAT, 3, 3, 2, 3) == (1, 0, 4)
    assert record(fl_slogdet.SQUARE, 16, 10, 0, 16) == (4, 0, 4)
    assert record(fl_slogdet.SQUARE, 16, 10, 0, 16, align=4) == (1, 1, 1)
    assert record(fl_slogdet.SQUARE, 16, 33, 0, 1) == (1, 1, 4)  # runs of 1089 floats
    assert record(fl_slogdet.SQUARE, 3, 5, 0, 3) == (1, 0, 4)  # 75 floats a walker and direction
    assert record(fl_slogdet.SQUARE_SPLIT, 16, 21, 21, 1) == (2, 1, 4)  # runs of 882 floats
    assert record(fl_slogdet.SQUARE_SPLIT, 3, 21, 21, 1) == (2, 0, 4)
