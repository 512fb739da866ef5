"""SRNets tap-MLP models, their fast stacks and weight import."""
