from .ssp import const_env, linear_gradient_env, munk_env, munk_ssp
