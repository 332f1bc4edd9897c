"""Symbol inventory for the text frontend.

Same 148-symbol inventory as the reference frontend so token ids (and
therefore checkpoints) are interchangeable:
pad + '-' + punctuation + ASCII letters + '@'-prefixed ARPAbet.
reference: DEX-TTS/text/symbols.py:5-14, DEX-TTS/text/cmudict.py:6-14.
"""

# The 39-phoneme ARPAbet set with 0/1/2 stress variants on vowels.
ARPABET_SYMBOLS = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2",
    "AH", "AH0", "AH1", "AH2", "AO", "AO0", "AO1", "AO2",
    "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH",
    "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2",
    "EY", "EY0", "EY1", "EY2",
    "F", "G", "HH",
    "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1", "IY2",
    "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2",
    "P", "R", "S", "SH", "T", "TH",
    "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]

PAD = "_"
SPECIAL = "-"
PUNCTUATION = "!'(),.:;? "
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# '@' prefix keeps ARPAbet ids disjoint from raw characters.
symbols = (
    [PAD]
    + list(SPECIAL)
    + list(PUNCTUATION)
    + list(LETTERS)
    + ["@" + s for s in ARPABET_SYMBOLS]
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

# Blank token used by `intersperse` sits one past the inventory
# (reference: DEX-TTS/src/dataset.py:81, main.py:60: n_vocab = len(symbols)+1).
BLANK_ID = len(symbols)
N_VOCAB = len(symbols) + 1
