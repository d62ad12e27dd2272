from repro_torch.optim.optimizers import (OptState, adam, make_optimizer, sgd,
                                          zo_sgd)
from repro_torch.optim.schedule import constant, cosine, warmup_cosine
