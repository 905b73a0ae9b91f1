from repro_torch.nn.module import (Param, ParamTree, init_params,  # noqa: F401
                                   param_count)
