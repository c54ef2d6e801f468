from .model import Model, build_model
from .transformer import (ParamTree, decode_step, forward, init_cache,
                          init_cache_specs, init_params)
from .weights import params_from_numpy
