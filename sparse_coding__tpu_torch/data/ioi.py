"""IOI (indirect-object identification) clean/corrupted prompt pairs.

Counterpart of `sparse_coding__tpu/data/ioi.py`, a copy (numpy only):
the same prompt templates, name/location/object pools and single-token
filtering; output is a pair of int32 token arrays.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

ABB_A_PROMPT = (
    "Then, {name_a} and {name_b} were working at the {location}. "
    "{name_b} decided to give a {object} to {name_a}"
)
ABA_B_PROMPT = (
    "Then, {name_a} and {name_b} were working at the {location}. "
    "{name_a} decided to give a {object} to {name_b}"
)

NAMES = [
    "James", "John", "Robert", "Michael", "William", "Mary", "David", "Joseph",
    "Richard", "Charles", "Thomas", "Christopher", "Daniel", "Matthew",
    "Elizabeth", "Patricia", "Jennifer", "Anthony", "George", "Linda",
    "Barbara", "Donald", "Paul", "Mark", "Andrew", "Steven", "Kenneth",
    "Edward", "Joshua", "Margaret", "Brian", "Kevin", "Jessica", "Sarah",
    "Susan", "Timothy", "Dorothy", "Jason", "Ronald", "Helen", "Ryan",
    "Jeffrey", "Karen", "Nancy", "Betty", "Lisa", "Jacob", "Nicholas",
    "Ashley", "Eric", "Frank", "Gary", "Anna", "Stephen", "Jonathan",
    "Sandra", "Emily", "Amanda", "Kimberly", "Michelle", "Donna", "Justin",
    "Laura", "Ruth", "Carol", "Brandon", "Larry", "Scott", "Melissa",
    "Stephanie", "Benjamin", "Raymond", "Samuel", "Rebecca", "Deborah",
    "Gregory", "Sharon", "Kathleen", "Amy", "Alexander", "Patrick", "Jack",
    "Henry", "Angela", "Shirley", "Emma", "Catherine", "Katherine",
    "Virginia", "Nicole", "Dennis", "Walter", "Tyler", "Peter", "Aaron",
    "Jerry", "Christine",
]
LOCATIONS = ["plateau", "cafe", "home", "bridge", "station"]
OBJECTS = ["feather", "towel", "fins", "ring", "tape", "shorts"]


def generate_ioi_dataset(
    encode: Callable[[str], List[int]],
    n_abb_a: int,
    n_abb_b: int,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """(clean, corrupted) token arrays. `encode` is text→ids (an HF tokenizer
    call or a test stub), applied both for single-token filtering and final
    tokenization."""
    rng = np.random.RandomState(seed)

    names = [n for n in NAMES if len(encode(" " + n)) == 1]
    bad = [w for w in LOCATIONS + OBJECTS if len(encode(" " + w)) != 1]
    assert not bad, f"Dataset is not valid: multi-token words {bad}"

    clean_texts, corrupted_texts = [], []
    for clean_tpl, corr_tpl, n in (
        (ABB_A_PROMPT, ABA_B_PROMPT, n_abb_a),
        (ABA_B_PROMPT, ABB_A_PROMPT, n_abb_b),
    ):
        for _ in range(n):
            name_a, name_b = rng.choice(names, size=2, replace=False)
            fills = dict(
                name_a=name_a,
                name_b=name_b,
                location=rng.choice(LOCATIONS),
                object=rng.choice(OBJECTS),
            )
            clean_texts.append(clean_tpl.format(**fills))
            corrupted_texts.append(corr_tpl.format(**fills))

    clean = np.asarray([encode(t) for t in clean_texts], dtype=np.int32)
    corrupted = np.asarray([encode(t) for t in corrupted_texts], dtype=np.int32)
    return clean, corrupted
