from repro_torch.data.corpus import pretrain_batches
from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        label_histogram,
                                        single_label_partition, subset)
from repro_torch.data.synthetic import TaskSpec, make_task_fns, sample_dataset
