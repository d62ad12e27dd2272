"""MEERKAT core in torch: the paper's contribution as composable modules."""
from repro_torch.core.dispatch import FlatBacking, get_backing, resolve_backend
from repro_torch.core.gradip import gradip_trajectory, pretrain_gradient_vec
from repro_torch.core.masks import sensitivity_mask, sensitivity_scores
from repro_torch.core.seeds import round_keys, step_key
from repro_torch.core.server import Client, CommLog, FederatedZO
from repro_torch.core.spaces import DenseSpace, MaskedSpace
from repro_torch.core.virtual_path import aggregate, reconstruct_delta
from repro_torch.core.vpcs import VPCSResult, analyze_trajectory, select_clients
from repro_torch.core.zo import local_step, make_local_run, projected_gradient
