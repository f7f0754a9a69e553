from .autoencoder import AutoEncoderParams, decode, init_decoder_params
from .encoders import TextEncoders
from .flux import (FluxModelConfig, FluxSparse, FluxState, FluxStep,
                   flux_forward, init_flux_params, params_from_jax)
from .hunyuan import (HunyuanModel, HunyuanModelConfig, init_hunyuan_params,
                      text_refiner)
from .flux_encoders import (ClipTextConfig, T5Config, clip_text_encode,
                            init_clip_params, init_t5_params,
                            load_clip_safetensors, load_t5_safetensors,
                            t5_encode)
from .loaders import (load_ae_decoder_safetensors, load_flux_params,
                      load_flux_safetensors, load_hunyuan_params,
                      load_hunyuan_safetensors, load_wan_params,
                      load_wan_safetensors)
from .sampling import FluxSampler, get_schedule, unpack
from .streamed import StreamedFluxRunner, StreamedFluxState
from .llama import (LlamaConfig, init_llama_params, llama_hidden_states,
                    llama_params_from_flax, load_llama_safetensors,
                    read_llama_config)
from .video_encoders import (PROMPT_TEMPLATE_ENCODE_VIDEO, VIDEO_CROP_START,
                             HunyuanTextEncoders, UMT5Config, WanTextEncoder,
                             init_umt5_params, load_umt5_torch,
                             select_skip_layer_hidden, umt5_encode)
from .video_vae import (HyVaeConfig, WanVaeConfig, hunyuan_vae_decode,
                        hunyuan_vae_params_from_jax, init_hunyuan_vae_decoder,
                        init_wan_vae_decoder, load_hunyuan_vae_decoder,
                        load_hunyuan_vae_safetensors, load_wan_vae,
                        load_wan_vae_decoder, wan_vae_decode,
                        wan_vae_params_from_jax)
from .video_sampling import (hunyuan_denoise, hunyuan_denoise_compiled,
                             wan_denoise, wan_denoise_compiled)
from .wan import (WanModel, WanModelConfig, WanState, init_wan_params)

__all__ = ['FluxModelConfig', 'init_flux_params', 'params_from_jax',
           'flux_forward', 'FluxSparse', 'FluxState', 'FluxStep',
           'FluxSampler', 'get_schedule', 'StreamedFluxRunner',
           'StreamedFluxState', 'HunyuanModelConfig',
           'HunyuanModel', 'init_hunyuan_params', 'text_refiner',
           'hunyuan_denoise', 'hunyuan_denoise_compiled', 'WanModelConfig',
           'WanModel', 'WanState', 'init_wan_params', 'wan_denoise',
           'wan_denoise_compiled', 'UMT5Config', 'init_umt5_params',
           'umt5_encode', 'load_umt5_torch', 'select_skip_layer_hidden',
           'WanTextEncoder', 'HunyuanTextEncoders',
           'PROMPT_TEMPLATE_ENCODE_VIDEO', 'VIDEO_CROP_START', 'LlamaConfig',
           'init_llama_params', 'llama_hidden_states',
           'load_llama_safetensors', 'read_llama_config',
           'llama_params_from_flax',
           'T5Config', 'init_t5_params', 't5_encode', 'load_t5_safetensors',
           'ClipTextConfig', 'init_clip_params', 'clip_text_encode',
           'load_clip_safetensors', 'TextEncoders', 'AutoEncoderParams',
           'decode', 'init_decoder_params', 'load_ae_decoder_safetensors',
           'load_flux_params', 'load_flux_safetensors', 'load_hunyuan_params',
           'load_hunyuan_safetensors', 'load_wan_params',
           'load_wan_safetensors',
           'unpack', 'HyVaeConfig', 'init_hunyuan_vae_decoder',
           'hunyuan_vae_decode', 'load_hunyuan_vae_decoder',
           'load_hunyuan_vae_safetensors', 'hunyuan_vae_params_from_jax',
           'WanVaeConfig', 'init_wan_vae_decoder', 'wan_vae_decode',
           'load_wan_vae_decoder', 'load_wan_vae', 'wan_vae_params_from_jax']
