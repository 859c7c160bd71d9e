"""Data and sequence parallelism of the PyTorch port (counterpart of
`xlstm_hved_tpu/parallel/`): `mesh` holds the process group, the mesh and
the collectives of the global-batch semantics; `seq` the sequence-parallel
mLSTM."""
