from repro_torch.models.init import init_params, param_count
from repro_torch.models.model import Model
from repro_torch.models.transformer import (DEFAULT_CTX, ModelCtx, forward,
                                            lm_loss)
