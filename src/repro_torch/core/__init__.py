"""MEERKAT core in torch: the paper's contribution as composable modules."""
from repro_torch.core.dispatch import FlatBacking, get_backing, resolve_backend
from repro_torch.core.fl_step import (make_fl_round_step, make_fl_train_loop,
                                      make_fl_train_step)
from repro_torch.core.gradip import (gradip_matrix, gradip_trajectory,
                                     pretrain_gradient_vec)
from repro_torch.core.masks import (magnitude_mask, random_mask,
                                    sensitivity_mask, sensitivity_scores)
from repro_torch.core.quantize import (IdentityCodec, IntCodec, QuantSpec,
                                       make_codec, quantize_roundtrip)
from repro_torch.core.sampling import ClientSampler
from repro_torch.core.seeds import round_keys, step_key
from repro_torch.core.server import Client, CommLog, FederatedZO
from repro_torch.core.spaces import DenseSpace, LoRASpace, MaskedSpace
from repro_torch.core.virtual_path import (aggregate, reconstruct_delta,
                                           reconstruct_from_wire,
                                           reconstruct_grad_vecs)
from repro_torch.core.vpcs import VPCSResult, analyze_trajectory, select_clients
from repro_torch.core.zo import local_step, make_local_run, projected_gradient
