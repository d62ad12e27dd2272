from repro_torch.train.first_order import fedavg_round, make_train_step
