from repro_torch.models.init import (active_param_count, init_params,
                                     param_count)
from repro_torch.models.model import Model, concrete_inputs
from repro_torch.models.transformer import (DEFAULT_CTX, ModelCtx, forward,
                                            lm_loss)
