"""S-RAPS core in PyTorch: types, scheduler, resource manager, engine."""
