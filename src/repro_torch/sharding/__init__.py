from repro_torch.sharding.fl import FLShardPlan, make_fl_plan
from repro_torch.sharding.rules import (Spec, batch_specs, cache_specs,
                                        fsdp_only_specs, mask_specs,
                                        param_specs, to_placements, token_spec)
