from .flux import (FluxModelConfig, FluxSparse, FluxState, FluxStep,
                   flux_forward, init_flux_params, params_from_jax)
from .hunyuan import (HunyuanModel, HunyuanModelConfig, init_hunyuan_params,
                      text_refiner)
from .sampling import FluxSampler, get_schedule
from .video_sampling import hunyuan_denoise

__all__ = ['FluxModelConfig', 'init_flux_params', 'params_from_jax',
           'flux_forward', 'FluxSparse', 'FluxState', 'FluxStep',
           'FluxSampler', 'get_schedule', 'HunyuanModelConfig',
           'HunyuanModel', 'init_hunyuan_params', 'text_refiner',
           'hunyuan_denoise']
