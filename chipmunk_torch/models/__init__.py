from .flux import (FluxModelConfig, FluxSparse, FluxState, FluxStep,
                   flux_forward, init_flux_params, params_from_jax)
from .sampling import FluxSampler, get_schedule

__all__ = ['FluxModelConfig', 'init_flux_params', 'params_from_jax',
           'flux_forward', 'FluxSparse', 'FluxState', 'FluxStep',
           'FluxSampler', 'get_schedule']
