"""Default dtypes of the port equal the JAX package's (x64 on): float64
for the general API and the multigrid tables, float32 for the flagship
``UnfittedPoisson``, which asks for it in its signature."""
import numpy as np
import jax.numpy as jnp
import torch

from ngsxfem_tpu.config import config as jax_config
from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
from ngsxfem_tpu.solvers import mg as jax_mg
from ngsxfem_tpu_torch.config import config
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import mg


def _name(dt):
    return str(np.dtype(dt)) if not isinstance(dt, torch.dtype) else \
        str(dt).replace("torch.", "")


def test_config_dtype_matches_jax():
    assert _name(config.dtype) == _name(jax_config.dtype) == "float64"


def test_model_and_mg_defaults_match_jax():
    mj = JaxPoisson(nx=4)
    mt = UnfittedPoisson(nx=4, device="cpu")
    assert _name(mj.vertices.dtype) == _name(mt.vertices.dtype) == "float32"
    assert _name(mj.lset.dtype) == _name(mt.lset.dtype) == "float32"
    st = mt.ell_structure()
    vals = np.ones(st["ell_cols"].shape)
    Mj = jax_mg.FunctionalELLMG([st["ell_cols"]], [])
    Mt = mg.FunctionalELLMG([st["ell_cols"]], [])
    pj = Mj.params([vals])
    pt = Mt.params([vals], device="cpu")
    assert _name(pj["vals"][0].dtype) == _name(pt["vals"][0].dtype) == \
        "float64"
