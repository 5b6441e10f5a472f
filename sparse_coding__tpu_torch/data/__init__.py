"""Data: synthetic generators, the chunk store, integrity checks, the
activation harvest and the IOI prompts (counterpart of
`sparse_coding__tpu/data`, with its names; `load_store_dataset` is not
ported)."""

from sparse_coding__tpu_torch.data.synthetic import (
    RandomDatasetGenerator,
    SparseMixDataset,
    generate_corr_matrix,
    generate_rand_feats,
)
from sparse_coding__tpu_torch.data.chunks import (
    ChunkStore,
    chunk_path,
    generate_synthetic_chunks,
    save_chunk,
)
from sparse_coding__tpu_torch.data.integrity import (
    ChunkLossBudget,
    CorruptChunk,
    chunk_manifest_path,
    quarantine_chunk,
    quarantined_indices,
    read_chunk_manifest,
    verify_chunk,
)
from sparse_coding__tpu_torch.data.activations import (
    chunk_and_tokenize_texts,
    chunk_tokens,
    harvest_folder_name,
    harvest_to_device,
    make_activation_dataset,
    setup_data,
    setup_token_data,
)
from sparse_coding__tpu_torch.data.ioi import generate_ioi_dataset
