"""SRNets tap-MLP models, their fast stacks, weight import and
checkpoints, and the LUT-as-model of fine-tuning."""
