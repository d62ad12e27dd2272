from repro_torch.serving.engine import (ContinuousBatchingEngine, Request,
                                        ServeEngine, generate)
