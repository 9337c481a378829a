"""Parallel execution on torch.distributed: one process drives one device
(a rank); collectives are explicit where the reference's single program
has a psum, ppermute or all_gather."""
