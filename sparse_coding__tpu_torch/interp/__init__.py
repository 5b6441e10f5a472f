"""Autointerp (counterpart of `sparse_coding__tpu/interp`): activation
records, the explain/simulate clients, the pipeline and its batch modes."""

from sparse_coding__tpu_torch.interp.records import (
    ActivationRecord,
    NeuronRecord,
    OPENAI_FRAGMENT_LEN,
    ScoredSimulation,
    SequenceSimulation,
    TOTAL_EXAMPLES,
    aggregate_scored_sequence_simulations,
    calculate_max_activation,
)
from sparse_coding__tpu_torch.interp.clients import (
    InterpClient,
    OpenAIClient,
    TokenLexiconClient,
    default_client,
    expected_activation_from_digit_logprobs,
    scores_from_completion_logprobs,
)
from sparse_coding__tpu_torch.interp.pipeline import (
    get_df,
    interpret,
    make_feature_activation_dataset,
    make_feature_activation_datasets,
    read_results,
    read_transform_scores,
    run,
    select_records,
)
from sparse_coding__tpu_torch.interp.batch import (
    InterpContext,
    interpret_across_baselines,
    interpret_across_big_sweep,
    interpret_across_chunks,
    make_tag_name,
    parse_folder_name,
    read_scores,
    run_folder,
    run_from_grouped,
    run_many,
)
