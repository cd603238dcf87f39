from repro_torch.optim.compression import (compressed_psum,
                                           compressed_psum_tree,
                                           ef_state_init)

__all__ = ["compressed_psum", "compressed_psum_tree", "ef_state_init"]
