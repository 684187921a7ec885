"""The parallel layer of the PyTorch port on the cards, tested on the CPU:
the default device of an entry point is the current card, a rank's card is
its own (``rank_device``), the multi-rank entry points start one NCCL rank
per card by default and raise when the cards are missing (nothing falls
back to gloo or to the CPU), and ``BilinearForm.AssembleOperator`` works on
a sharded mesh.

The card functions of ``torch.cuda`` are monkeypatched where a test needs a
card count or a current card, so that no test needs a card.  The sharded
``AssembleOperator`` runs on 1, 2 and 4 gloo ranks (``spawn_ranks(...,
device="cpu")``, once per world size for the module), on the fictitious
domain form of tests/test_operator.py as a P1 form in 3D and a P2 form in
2D, as the stencil and as the partial-assembly operator: its ``matvec`` and
``diagonal()`` equal the single-rank operator's bit for bit on every rank,
and the JAX package's unsharded operator within tests/test_operator.py's
1e-12 of the largest entry.

JAX is imported inside the tests only: the spawned ranks import this module
to find ``_operator_job`` and must not start JAX.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ngsxfem_tpu_torch as T
from ngsxfem_tpu_torch.config import resolve_device
from ngsxfem_tpu_torch.parallel import (dryrun_multichip, init_group,
                                        rank_device, shard_space,
                                        spawn_ranks)
from ngsxfem_tpu_torch.parallel import sharding

WORLDS = (1, 2, 4)
# (dim, order) of the sharded operators, at tests/test_operator.py's nx=6
FORMS = ((3, 1), (2, 2))
KINDS = ("stencil", "pa")
OP_TOL = 1e-12  # tests/test_operator.py: of the largest entry


def _fictdom(N, dim, order, nx=6, **dev):
    """tests/test_operator.py's fictitious domain form (sphere r=0.4,
    Nitsche, facet-patch ghost penalty)."""
    if dim == 3:
        mesh = N.MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx)
        lev = N.sqrt((N.x - .5) ** 2 + (N.y - .5) ** 2 + (N.z - .5) ** 2) - .4
    else:
        mesh = N.MakeStructured2DMesh(quads=False, nx=nx, ny=nx)
        lev = N.sqrt((N.x - .5) ** 2 + (N.y - .5) ** 2) - 0.4
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **dev))
    N.InterpolateToP1(lev, lsetp1)
    ci = N.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    hasif = ci.GetElementsOfType(N.IF)
    V = N.H1(mesh, order=order, dgjumps=True, **dev)
    u, v = V.TnT()
    h = N.specialcf.mesh_size
    nl = 1.0 / N.Norm(N.grad(lsetp1)) * N.grad(lsetp1)
    gp = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    a = N.BilinearForm(V)
    a += N.SymbolicBFI({"levelset": lsetp1, "domain_type": N.NEG},
                       form=N.grad(u) * N.grad(v), definedonelements=hasneg)
    a += N.SymbolicBFI({"levelset": lsetp1, "domain_type": N.IF},
                       form=-(N.grad(u) * nl) * v - (N.grad(v) * nl) * u
                       + 40.0 / h * u * v)
    a += N.SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=gp)
    return V, a


def _seeded_x(ndof):
    return np.random.default_rng(ndof).standard_normal(ndof)


def _apply_both(a, ndof):
    """{kind: (matvec of the seeded x, diagonal, the operator's kind)} of
    ``a.AssembleOperator()`` and ``a.AssembleOperator(lattice=False)``."""
    x = torch.as_tensor(_seeded_x(ndof))
    out = {}
    for kind, lattice in zip(KINDS, ("auto", False)):
        op = a.AssembleOperator(lattice)
        out[kind] = (op.matvec(x).numpy(), op.diagonal().numpy(), op.kind)
    return out


def _operator_job(group):
    """The sharded operators of every form on this rank ({(dim, order):
    {kind: ...}}, with the collectives and bytes of their builds), and on
    rank 0 the single-rank operators built in the same process."""
    out = {"sharded": {}, "single": {}, "calls": {}}
    for dim, order in FORMS:
        V, a = _fictdom(T, dim, order, device="cpu")
        shard_space(V, group)
        c0, b0 = group.calls, group.bytes
        out["sharded"][dim, order] = _apply_both(a, V.ndof)
        out["calls"][dim, order] = (group.calls - c0, group.bytes - b0)
        if group.rank == 0:
            V1, a1 = _fictdom(T, dim, order, device="cpu")
            out["single"][dim, order] = _apply_both(a1, V1.ndof)
    return out


@pytest.fixture(scope="module")
def operator_ranks():
    """``_operator_job`` on 1, 2 and 4 gloo ranks: {world size: results}."""
    return {n: spawn_ranks(n, _operator_job, device="cpu") for n in WORLDS}


@pytest.fixture(scope="module")
def jax_operators():
    """The JAX package's unsharded operators on the same forms and seeded
    vectors: {(dim, order): {kind: (matvec, diagonal)}}."""
    import jax.numpy as jnp
    import ngsxfem_tpu as J

    out = {}
    for dim, order in FORMS:
        V, a = _fictdom(J, dim, order)
        x = jnp.asarray(_seeded_x(V.ndof))
        out[dim, order] = {}
        for kind, lattice in zip(KINDS, ("auto", False)):
            op = a.AssembleOperator(lattice)
            out[dim, order][kind] = (np.asarray(op.matvec(x)),
                                     np.asarray(op.diagonal()))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"dim{f[0]}p{f[1]}")
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_assemble_operator(operator_ranks, jax_operators, n, form,
                                   kind):
    """``AssembleOperator`` on a sharded mesh (n gloo ranks): every rank's
    ``matvec`` and ``diagonal()`` equal the single-rank operator's bit for
    bit and the JAX package's unsharded operator within 1e-12 of the
    largest entry; the build is one all-reduce of the element stream."""
    res = operator_ranks[n]
    y1, d1, kind1 = res[0]["single"][form][kind]
    assert kind1 == kind
    for r in res:
        y, d, k = r["sharded"][form][kind]
        assert k == kind
        assert np.array_equal(y, y1) and np.array_equal(d, d1), r
        calls, nbytes = r["calls"][form]
        assert calls == len(KINDS) and nbytes > 0
    yj, dj = jax_operators[form][kind]
    assert np.abs(y1 - yj).max() <= OP_TOL * np.abs(yj).max()
    assert np.abs(d1 - dj).max() <= OP_TOL * np.abs(dj).max()


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def _never(group):  # pragma: no cover - must not be spawned
    raise AssertionError("spawned without the cards")


def test_rank_device(monkeypatch):
    """Rank r runs on ``cuda:r``, or on ``cuda:LOCAL_RANK`` when a launcher
    set it; a rank past the card count raises (no shared card, no CPU)."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [rank_device(r, 4) for r in range(4)] == [
        torch.device("cuda", r) for r in range(4)]
    with pytest.raises(RuntimeError):
        rank_device(4, 4)
    with pytest.raises(RuntimeError):
        rank_device(0, 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device(0, 4) == torch.device("cuda", 3)
    assert rank_device(7, 4) == torch.device("cuda", 3)
    with pytest.raises(RuntimeError):
        rank_device(0, 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("LOCAL_RANK", "")
    assert rank_device(5) == torch.device("cuda", 5)


def test_resolve_device_follows_current_card(monkeypatch):
    """With no device given the port's tensors go to the current card (a
    rank's own after ``set_device``); the CPU only when asked for; without
    a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert resolve_device() == torch.device("cuda", 2)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError):
        resolve_device()


def test_init_group_puts_rank_on_its_card(monkeypatch, tmp_path):
    """``init_group(rank, ...)`` without a device takes the rank's card,
    makes it current before NCCL starts and returns a group on it."""
    calls = []
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(sharding.dist, "FileStore", lambda *a: "store")
    monkeypatch.setattr(sharding.dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            (backend, kw["rank"], kw["world_size"])))
    g = init_group(2, 4, str(tmp_path / "s"))
    assert g.device == torch.device("cuda", 2)
    assert calls == [("set_device", torch.device("cuda", 2)), ("nccl", 2, 4)]
    calls.clear()
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert init_group(5, 8, str(tmp_path / "s")).device == \
        torch.device("cuda", 1)
    assert calls == [("set_device", torch.device("cuda", 1)), ("nccl", 5, 8)]
    calls.clear()
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError):  # rank 4 of 5 on a four-card host
        init_group(4, 5, str(tmp_path / "s"))
    assert calls == []


def test_no_card_raises(monkeypatch, tmp_path):
    """Without a card the multi-rank entry points raise before they spawn
    or join anything: ``spawn_ranks``, ``dryrun_multichip`` and
    ``init_group`` default to the cards; a device that is neither the cards
    nor the CPU is refused."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="visible"):
        spawn_ranks(2, _never)
    with pytest.raises(RuntimeError, match="visible"):
        dryrun_multichip(2)
    store = tmp_path / "store"
    with pytest.raises(RuntimeError, match="visible"):
        init_group(0, 1, str(store))
    assert not store.exists() and not dist.is_initialized()
    with pytest.raises(ValueError):
        spawn_ranks(2, _never, device="cuda:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="visible"):  # two ranks, one card
        spawn_ranks(2, _never)
    with pytest.raises(RuntimeError, match="visible"):
        dryrun_multichip(2)
