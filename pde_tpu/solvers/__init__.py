"""PDE solvers: Crank-Nicolson 1D (constant + local vol), Douglas ADI 2D
(In 't Hout-Foulon boundaries), absorbing-boundary barriers, jump-diffusion
PIDE (Merton/Kou, matmul jump convolution), HJB optimal stopping,
Longstaff-Schwartz."""

from . import (  # noqa: F401
    barrier_pde,
    bates_pide,
    bermudan_g2,
    bermudan_hw,
    bs_pde,
    heston_adi,
    heston_adi_ref,
    hjb,
    local_vol_pde,
    lsm,
    lsm_dual,
    pide,
)
