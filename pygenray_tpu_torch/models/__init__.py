from .ssp import const_env, linear_gradient_env, munk_env, munk_ssp
from .internal_waves import iw_perturbations, perturbed_munk_tables
