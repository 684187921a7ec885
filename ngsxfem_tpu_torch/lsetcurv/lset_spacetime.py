"""Space-time isoparametric level-set mesh adaptation.

Counterpart of ``ngsxfem_tpu/lsetcurv/lset_spacetime.py`` (the reference's
``spacetime/lset_spacetime.py:12-256``, LevelSetMeshAdaptation_Spacetime):
at each time node of the slab's time FE the time-dependent level set is
interpolated to high order and to P1 and a spatial shift (ProjectShift) is
computed on the elements that the slab cuts at any time; the per-node
results are stacked into space-time GridFunctions (lset_ho, lset_p1,
deform).  The deformation is a space-time GridFunction: an integral under
it evaluates it at each quadrature point's time
(``fem.gridfunction.gf_ref_value_and_grad``).

Time enters through ``tref`` (the slab-reference time CF): the slab loop
composes absolute time as ``t_start + dt * tref``, in place of the
reference's Parameter.FixTime mechanism.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fem.space import BitArray
from ..fem.gridfunction import GridFunction, InterpolateToP1
from ..domaintype import NEG, POS, IF
from .lsetcurv import LevelSetMeshAdaptation


class LevelSetMeshAdaptation_Spacetime:
    """Space-time mesh adaptation (cf. spacetime/lset_spacetime.py).  Its
    spaces and GridFunctions live on ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, mesh, order_space=2, order_time=1, lset_lower_bound=0,
                 lset_upper_bound=0, threshold=-1, discontinuous_qn=True,
                 heapsize=None, periodic=False, device=None):
        from ..spacetime.space import SpaceTimeFESpace
        from ..spacetime.timefe import ScalarTimeFE

        self.mesh = mesh
        self.order_space = order_space
        self.order_time = order_time
        self.threshold = threshold
        # nodal machinery: high-order, P1 and deformation spaces + the shift
        self.nodal = LevelSetMeshAdaptation(
            mesh, order=order_space, threshold=threshold,
            discontinuous_qn=discontinuous_qn, periodic=periodic,
            device=device)
        self.tfe = ScalarTimeFE(order_time)
        self.v_ho_st = SpaceTimeFESpace(self.nodal.ho_space, self.tfe)
        self.v_p1_st = SpaceTimeFESpace(self.nodal.p1_space, self.tfe)
        self.v_def_st = SpaceTimeFESpace(self.nodal.deform_space, self.tfe)
        self.lset_ho = GridFunction(self.v_ho_st, "lset_ho_st")
        self.lset_p1 = GridFunction(self.v_p1_st, "lset_p1_st")
        self.deform = GridFunction(self.v_def_st, "deform_st")
        self.levelset = None
        ne = mesh.ne
        self.hasneg_spacetime = BitArray(np.zeros(ne, dtype=bool))
        self.haspos_spacetime = BitArray(np.zeros(ne, dtype=bool))
        self.hasif_spacetime = BitArray(np.zeros(ne, dtype=bool))

    @property
    def lset_p1_node(self):
        return self.nodal.lset_p1

    def interpol_ho(self, levelset):
        """High-order spatial interpolation at every time node (reference
        lset_spacetime.py:84-94)."""
        from ..spacetime.space import TimeFixedCF

        blocks = []
        for tn in self.tfe.nodes:
            self.nodal.lset_ho.Set(TimeFixedCF(levelset, float(tn)))
            blocks.append(self.nodal.lset_ho._arr)
        self.lset_ho._set_array(torch.cat(blocks))

    def interpol_p1(self):
        """P1 vertex interpolation node by node (reference
        lset_spacetime.py:96-100)."""
        nds = self.nodal.ho_space.ndof
        blocks = []
        for i in range(self.tfe.ndof):
            self.nodal.lset_ho._set_array(
                self.lset_ho._arr[i * nds:(i + 1) * nds])
            InterpolateToP1(self.nodal.lset_ho, self.nodal.lset_p1)
            blocks.append(self.nodal.lset_p1._arr)
        self.lset_p1._set_array(torch.cat(blocks))

    def CalcDeformation(self, levelset, tstart=None, dt=None, calc_kappa=False):
        """The space-time deformation of one slab.

        ``levelset`` is a CF in ``tref`` (slab-local time); compose the
        absolute time yourself (t_start + dt * tref), as
        examples/moving_domain does.
        """
        from ..geom.cutinfo import CutInfo

        self.levelset = levelset
        self.interpol_ho(levelset)
        self.interpol_p1()

        # space-time cut classification over the slab
        ci = CutInfo(self.mesh, self.lset_p1, time_order=self.order_time)
        self.ci = ci
        self.hasneg_spacetime = ci.GetElementsOfType(NEG) | ci.GetElementsOfType(IF)
        self.haspos_spacetime = ci.GetElementsOfType(POS) | ci.GetElementsOfType(IF)
        self.hasif_spacetime = ci.GetElementsOfType(IF)
        band = self.hasif_spacetime.np

        nds = self.nodal.ho_space.ndof
        ndp = self.nodal.p1_space.ndof
        blocks = []
        for i in range(self.tfe.ndof):
            self.nodal.lset_ho._set_array(
                self.lset_ho._arr[i * nds:(i + 1) * nds])
            self.nodal.lset_p1._set_array(
                self.lset_p1._arr[i * ndp:(i + 1) * ndp])
            self.nodal._shift_from_nodal(
                self.nodal.lset_ho, self.nodal.lset_p1, self.nodal.deform,
                band=band)
            blocks.append(self.nodal.deform._arr)
        self.deform._set_array(torch.cat(blocks))
        return self.deform

    def CalcMaxDistance(self, levelset=None, given_pts=None, heapsize=None):
        """max over the sampled times of the nodal geometric distance
        estimate (reference lset_spacetime.py CalcMaxDistance)."""
        from ..spacetime.space import RestrictGFInTime, TimeFixedCF

        levelset = levelset if levelset is not None else self.levelset
        times = list(given_pts) if given_pts else list(self.tfe.nodes)
        dev = self.deform.device
        deform_node = GridFunction(self.nodal.deform_space, device=dev)
        lset_p1_node = GridFunction(self.nodal.p1_space, device=dev)
        dists = []
        for t in times:
            RestrictGFInTime(self.lset_p1, float(t), lset_p1_node)
            RestrictGFInTime(self.deform, float(t), deform_node)
            self.nodal.lset_p1._set_array(lset_p1_node._arr)
            dists.append(self.nodal.CalcMaxDistance(
                TimeFixedCF(levelset, float(t)), deform=deform_node))
        return max(dists)
