from .flux import (FluxModelConfig, FluxSparse, FluxState, FluxStep,
                   flux_forward, init_flux_params, params_from_jax)
from .hunyuan import (HunyuanModel, HunyuanModelConfig, init_hunyuan_params,
                      text_refiner)
from .sampling import FluxSampler, get_schedule
from .video_encoders import (UMT5Config, init_umt5_params, load_umt5_torch,
                             umt5_encode)
from .video_sampling import hunyuan_denoise, wan_denoise
from .wan import (WanModel, WanModelConfig, WanState, init_wan_params)

__all__ = ['FluxModelConfig', 'init_flux_params', 'params_from_jax',
           'flux_forward', 'FluxSparse', 'FluxState', 'FluxStep',
           'FluxSampler', 'get_schedule', 'HunyuanModelConfig',
           'HunyuanModel', 'init_hunyuan_params', 'text_refiner',
           'hunyuan_denoise', 'WanModelConfig', 'WanModel', 'WanState',
           'init_wan_params', 'wan_denoise', 'UMT5Config',
           'init_umt5_params', 'umt5_encode', 'load_umt5_torch']
