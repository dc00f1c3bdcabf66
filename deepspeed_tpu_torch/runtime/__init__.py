"""Training runtime of the port: config, engine, optimizers, LR schedules, loss scaling, data loading."""
