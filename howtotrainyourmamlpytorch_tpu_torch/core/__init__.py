"""The bi-level MAML core: partition, LSLR, MSL and the serving learner."""
