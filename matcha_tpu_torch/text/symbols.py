"""Phoneme symbol inventory and stable ID assignment.

The ID layout is a *data contract*: checkpoints bake these IDs into the
embedding table, so the inventory and ordering must match the reference
exactly (reference: matcha/text/symbols.py:8-39).  Every voiced phoneme P
additionally owns two derived context tokens, PRE(P) = PRE_ID + id(P) and
POST(P) = POST_ID + id(P), modelling the co-articulation transitions into
and out of the phoneme (reference: documentation/components.md:11-37).

Layout
------
  [0]               separator '|'
  [1 .. 26]         punctuation (many stripped before the model in practice)
  [27 ..]           IPA vowels, consonants, stress marks, length/diacritics
  [200 .. 399]      PRE variants of voiced phonemes   (PRE_ID + base id)
  [400 .. 599]      POST variants of voiced phonemes  (POST_ID + base id)
"""

from __future__ import annotations

SEPARATOR = "|"

# WARNING: order is frozen — IDs are baked into checkpoints.
PUNCTUATION = ";:,.!?¡¿_—…-'\"«»“”()[]/ "

# IPA inventory covering en/es/pt/fr/de/it/ro/ja/he as produced by eSpeak-ng.
VOWELS = "aeiouɑɐɒæəɘɚɛɜɝɞɨɪɔøɵɤʉʊyɶœɯʏʌᵻ"
CONSONANTS = "bβcçdðfɡɢɣhɦɧħɥjɟʝkʎlɭʟɬɫɮmɱnɳɲŋɴpɸqrɹɺɾɽɻʀʁsʂʃtʈθvʋⱱwʍxχzʐʒʑʔʕʢʡʙɕɖʜɰ"
PRE_ANNOTATIONS = "ˈˌ"
# Trailing five are combining diacritics: syllabic, inverted breve below,
# tilde, left angle above, bridge below.
POST_ANNOTATIONS = "ːˑ‿ʰʱʲʷˠˤ˞ⁿˡʼʴ̩̯̪̃̚"

IPA_SYMBOLS = VOWELS + CONSONANTS + PRE_ANNOTATIONS + POST_ANNOTATIONS

symbols: list[str] = [SEPARATOR] + list(PUNCTUATION) + list(IPA_SYMBOLS)

symbol_to_id: dict[str, int] = {s: i for i, s in enumerate(symbols)}
id_to_symbol: dict[int, str] = {i: s for s, i in symbol_to_id.items()}

voiced_phoneme_ids: frozenset[int] = frozenset(
    symbol_to_id[s] for s in VOWELS + CONSONANTS if s in symbol_to_id
)

SPACE_ID: int = symbols.index(" ")

PRE_ID = 200
POST_ID = 2 * PRE_ID
N_VOCAB = 3 * PRE_ID

assert len(symbols) < PRE_ID, "base symbol inventory must fit below PRE_ID"
