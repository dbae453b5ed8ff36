"""Grammar-constrained decoding (port of
``flexflow_tpu/generation/constrained``).

JSON-Schema / regex -> character DFA -> token DFA compiled once per
(grammar, vocabulary) and cached; a per-request MaskState the scheduler
advances during host bookkeeping; cached per-state mask rows written into
the engine's persistent mask buffers, which every step kind (prefill,
suffix prefill, decode, verify) adds to its logits inside its captured
graph. Plain Python and numpy: nothing here touches the device.
"""
from .automaton import CharDFA, compile_regex
from .errors import GrammarError, MaskAdvanceError, MaskDeadEndError
from .schema import schema_to_regex, validate_json
from .tokens import (
    NEG,
    GrammarCache,
    MaskState,
    TokenDFA,
    compile_response_format,
    decode_text,
    default_vocabulary,
    grammar_alphabet,
)

__all__ = [
    "CharDFA",
    "GrammarCache",
    "GrammarError",
    "MaskAdvanceError",
    "MaskDeadEndError",
    "MaskState",
    "NEG",
    "TokenDFA",
    "compile_regex",
    "compile_response_format",
    "decode_text",
    "default_vocabulary",
    "grammar_alphabet",
    "schema_to_regex",
    "validate_json",
]
