"""The pieces of ``csrc/eigh.cu`` (the port's batched float64 Jacobi
eigensolver) held on the CPU through their numpy twins in
``mrbayes_tpu_torch/ops/eigh_cuda.py``:

* the moving layout (round 0's layout stepped by ``next_pos``) puts
  each round's pairs of the circle schedule ``round_pairs`` at positions
  (2k, 2k + 1), at n = 10, 20, 62 and 64, and a sweep returns to round
  0's layout;
* the static thread maps of the S = 20 and 61 instantiations and of the
  runtime-S one at S = 9 and 64: each round the producers' tiles and the
  rounds' diagonal blocks read each upper-triangle position of A once
  and write each position of the next layout once, and the consumer
  warps' rows partition V's rows;
* the two-rsqrt rotation ``schur`` is the textbook symmetric Schur
  rotation;
* V rebuilt by the consumer warps from the rounds the producers publish,
  through a ring of ``RING`` slots with the warps lagging at random, in
  the moving layout and moved back to labels at the end, equals
  ``jacobi_twin``'s V bit for bit;
* the thread splits and ring depth are the kernel's, and every S from 9
  to 64 fits a block's shared memory;
* ``jacobi_twin`` reads the lower triangle (as ``torch.linalg.eigh``
  does), and its P(t) agrees with the JAX package's ``eigh_reversible`` +
  ``transition_probs`` within 1e-5 (JAX solves in float32).

The kernel itself runs only on a GPU: the ``gpu``-marked tests below hold
it against its kept first design (``mb_eigh_jacobi_before``) on the same
batches, and its plan against ``eigh_plan``; they skip here."""
import os
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu_torch.eigh_bench import reversible_batch
from mrbayes_tpu_torch.ops import eigh_cuda as E

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(E.__file__), os.pardir, "csrc", "eigh.cu")


def _generator(S, seed):
    """One seeded symmetrised reversible generator [S, S] and its
    frequencies."""
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(np.ones(S) * 2)
    R = np.zeros((S, S))
    R[np.triu_indices(S, 1)] = rng.gamma(1.0, 1.0, S * (S - 1) // 2)
    Q = (R + R.T) * pi[None]
    np.fill_diagonal(Q, -Q.sum(1))
    Q /= -(pi * np.diag(Q)).sum()
    sq = np.sqrt(pi)
    A = Q * (sq[:, None] / sq[None, :])
    return 0.5 * (A + A.T), Q, pi


@pytest.mark.parametrize("n", [10, 20, 62, 64])
def test_moving_layout_is_the_circle_schedule(n):
    """The kernel's schedule: round 0's layout moved r times by next_pos
    puts round r's pairs of ``round_pairs`` at positions (2k, 2k + 1),
    and n - 1 moves bring every label back (a sweep ends in round 0's
    layout)."""
    for r in range(n - 1):
        lay = E.round_layout(n, r)
        assert [tuple(sorted(lay[2 * k:2 * k + 2].tolist()))
                for k in range(n // 2)] == E.round_pairs(n, r)
    assert np.array_equal(E.round_layout(n, n - 1), E.label_of(n))
    assert sorted(E.next_pos(n).tolist()) == list(range(n))


@pytest.mark.parametrize("S", [20, 61, 9, 64])
def test_thread_maps_cover_each_entry_once(S):
    """Each round the producers' tiles and warp 0's diagonal blocks read
    each upper-triangle position of A once and write each position of the
    next layout once (A is double-buffered), and the consumer warps' rows
    partition V's rows (so warps at different rounds share no entry)."""
    plan = E.eigh_plan(S)
    assert plan["instantiation"] == (S if S in (20, 61) else 0)
    n, half = S + (S & 1), (S + (S & 1)) // 2
    step = E.next_pos(n)
    upper = sorted((i, j) for i in range(n) for j in range(i, n))
    read, written = Counter(), Counter()
    for k in range(half):                        # warp 0's rotations
        p, q = 2 * k, 2 * k + 1
        read.update([(p, p), (p, q), (q, q)])
        written.update([(step[p], step[p]), (step[q], step[q]),
                        tuple(sorted((step[p], step[q])))])
    tiles = E.producer_tiles(S, plan["producers"])
    assert max(len(t) for t in tiles) <= 2       # the kernel's registers
    for mine in tiles:
        for k, l in mine:
            for i in (2 * k, 2 * k + 1):
                for j in (2 * l, 2 * l + 1):
                    read[(i, j)] += 1
                    written[tuple(sorted((step[i], step[j])))] += 1
    assert sorted(read) == upper and set(read.values()) == {1}
    assert sorted(written) == upper and set(written.values()) == {1}
    rows = E.consumer_rows(S, plan["consumer_warps"])
    assert sorted(i for rr in rows for i in rr) == list(range(S))
    assert max(len(rr) for rr in rows) <= 32 and half <= 32


@pytest.mark.parametrize("S", [9, 20, 61, 64])
def test_ring_replay_rebuilds_twin_v_bit_for_bit(S):
    A, _, _ = _generator(S, S)
    log = []
    _, V, sweeps = E.jacobi_twin(A, log)
    assert len(log) == sweeps * (S + (S & 1) - 1)
    warps = E.eigh_plan(S)["consumer_warps"]
    for seed in range(2):
        Vr = E.ring_replay(S, log, warps, np.random.default_rng(seed))
        assert np.array_equal(Vr, V)


def test_ring_replay_catches_a_slot_reused_too_early():
    """The replay's check has teeth: without the wait on a slot's release
    a lagging warp reads a slot the producer has overwritten; with it, a
    ring of one slot still gives the twin's V (producer and warps in
    lockstep)."""
    A, _, _ = _generator(20, 1)
    log = []
    _, V_twin, _ = E.jacobi_twin(A, log)
    warps = E.eigh_plan(20)["consumer_warps"]
    with pytest.raises(AssertionError, match="reads message"):
        E.ring_replay(20, log, warps, np.random.default_rng(0), ring=2,
                      wait_release=False)
    V = E.ring_replay(20, log, warps, np.random.default_rng(0), ring=1)
    assert np.array_equal(V, V_twin)


def test_schur_is_the_textbook_rotation():
    """The kernel's two-rsqrt form of the symmetric Schur rotation against
    Golub and Van Loan's t = sign(tau) / (|tau| + sqrt(1 + tau^2)):
    within a few rounding errors, c^2 + s^2 = 1, the pivot annihilated,
    t = 1 where tau = 0 (to rounding), the identity where a_pq = 0, and
    tiny pivots (1e-300) handled by the power-of-two scaling."""
    rng = np.random.default_rng(0)
    app, aqq, apq = rng.standard_normal((3, 20_000))
    apq[:10] = 0.0
    aqq[10:20] = app[10:20]
    apq[20:30] *= 1e-300
    c, s, t = E.schur(app, aqq, apq)
    with np.errstate(all="ignore"):
        tau = (aqq - app) / (2.0 * apq)
        t0 = np.where(tau >= 0.0, 1.0, -1.0) / (np.abs(tau) +
                                                np.sqrt(1.0 + tau * tau))
    t0 = np.where(apq != 0.0, t0, 0.0)
    np.testing.assert_allclose(t, t0, atol=2e-15, rtol=0)
    np.testing.assert_allclose(c * c + s * s, 1.0, atol=2e-15, rtol=0)
    np.testing.assert_allclose(t[10:20], 1.0, atol=2e-15, rtol=0)
    assert np.all(c[:10] == 1.0) and np.all(s[:10] == 0.0)
    new_pq = (c * c - s * s) * apq + c * s * (app - aqq)
    assert np.all(np.abs(new_pq) <= 1e-15 * np.abs(apq) + 1e-15 * np.abs(
        app - aqq) * np.abs(s))


def test_splits_and_ring_are_the_kernels():
    src = open(SRC).read()
    found = dict(re.findall(
        r"struct Split(?:<(\d+)>)? \{\n  static constexpr int producers = "
        r"(\d+, consumer_warps = \d+);", src))
    splits = {int(k or 0): tuple(int(x) for x in re.findall(r"\d+", v))
              for k, v in found.items()}
    assert splits == E.SPLITS
    assert f"constexpr int kRing = {E.RING};" in src
    assert f"constexpr int kRingLog = {E.RING.bit_length() - 1};" in src


def test_every_s_fits_a_block():
    sizes = {S: E.eigh_plan(S) for S in range(E.MIN_S, E.MAX_S + 1)}
    assert all(p["smem_bytes"] <= 232_448 and p["threads"] <= 1024
               for p in sizes.values())
    # the header's figures
    assert [sizes[S]["smem_bytes"] for S in (20, 61, 64)] == \
        [7_872, 65_888, 69_920]
    src = open(SRC).read()
    assert "7,872 bytes at S = 20, 65,888 at S = 61 and 69,920 at S = 64" \
        in " ".join(src.replace("//", " ").split())


@pytest.mark.parametrize("S", [20, 61])
def test_twin_reads_the_lower_triangle(S):
    A, _, _ = _generator(S, 7)
    junk = A + np.triu(np.random.default_rng(0).standard_normal((S, S)), 1)
    w, V, _ = E.jacobi_twin(junk)
    wt, Vt = torch.linalg.eigh(torch.as_tensor(junk))       # UPLO "L"
    np.testing.assert_allclose(np.sort(w), wt.numpy(), atol=1e-13, rtol=0)
    w0, V0, _ = E.jacobi_twin(A)
    assert np.array_equal(w, w0) and np.array_equal(V, V0)


@pytest.mark.parametrize("S", [20, 61])
def test_twin_p_matches_jax(S):
    """P(t) from the twin's eigensystem against the JAX package's
    ``eigh_reversible`` + ``transition_probs`` (float32 there)."""
    A, Q, pi = _generator(S, 11)
    w, V, _ = E.jacobi_twin(A)
    sq = np.sqrt(pi)
    U, Uinv = V / sq[:, None], V.T * sq[None, :]
    lam_j, U_j, V_j = JTP.eigh_reversible(jnp.asarray(Q, jnp.float32),
                                          jnp.asarray(pi, jnp.float32))
    for t in (0.01, 0.1, 1.0):
        P = U @ np.diag(np.exp(w * t)) @ Uinv
        P_j = np.asarray(JTP.transition_probs(
            lam_j, U_j, V_j, jnp.asarray(t, jnp.float32)))
        np.testing.assert_allclose(P, P_j, atol=1e-5, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(8, 20), (32, 20), (24, 61), (96, 61),
                                 (8, 9), (8, 60), (8, 64)])
def test_eigh_kernel_matches_before_on_gpu(cuda_device, B, S):
    """The kernel against its kept first design on the same batch: sweeps
    within one on every matrix, P(t) within 1e-10, and no host sync."""
    A = torch.as_tensor(reversible_batch(np.random.default_rng(B + S), B, S),
                        device=cuda_device)
    out = [(torch.empty((B, S), dtype=torch.float64, device=cuda_device),
            torch.empty((B, S, S), dtype=torch.float64, device=cuda_device),
            torch.empty(B, dtype=torch.int32, device=cuda_device))
           for _ in range(2)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        E.eigh_cuda(A)
        for (w, V, sw), before in zip(out, (False, True)):
            assert E.eigh_launch(A, w, V, sw, before=before) == 0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (w, V, sw), (wb, Vb, swb) = out
    assert (sw - swb).abs().max().item() <= 1
    for t in (0.01, 0.1, 1.0, 10.0):
        P = V @ torch.diag_embed(torch.exp(w * t)) @ V.transpose(-1, -2)
        Pb = Vb @ torch.diag_embed(torch.exp(wb * t)) @ Vb.transpose(-1, -2)
        assert (P - Pb).abs().max().item() < 1e-10


@pytest.mark.gpu
def test_eigh_plan_matches_twin_on_gpu(cuda_device):
    for S in range(E.MIN_S, E.MAX_S + 1):
        assert E.device_plan(S) == E.eigh_plan(S)
