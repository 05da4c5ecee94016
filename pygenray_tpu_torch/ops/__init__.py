from . import cheb, host, interp
