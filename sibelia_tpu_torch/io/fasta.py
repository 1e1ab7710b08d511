"""FASTA reading/writing with reference-parity semantics.

Parity notes (reference: src/fasta.cpp, src/fasta.h):
  * lines are trimmed of surrounding whitespace; empty lines skipped
  * a header is truncated to its first space-separated token (fasta.cpp:76-90)
  * sequence chars are uppercased and validated against "ACGTURYKMSWBDHWNX-"
    (the reference's exact set, quirks included: no 'V', 'W' twice)
  * records get consecutive 0-based ids continuing across files
  * GetStripedId: replace '|' and '.' with spaces; if exactly 5 tokens result,
    return token[3] (NCBI "gi|xxx|ref|ACC|" convention), else the description
"""
from __future__ import annotations

from dataclasses import dataclass

VALID_CHARS = set("ACGTURYKMSWBDHWNX-")
DEFINITE_BASE = "ACGT"

_COMP = {"A": "T", "T": "A", "G": "C", "C": "G", "a": "t", "t": "a", "g": "c", "c": "g"}


def translate_char(ch: str) -> str:
    """Complement of a base; non-ACGT chars map to themselves
    (reference: src/dnasequence.cpp:11-28)."""
    return _COMP.get(ch, ch)


def reverse_complement(s: str) -> str:
    return "".join(_COMP.get(c, c) for c in reversed(s))


@dataclass
class FASTARecord:
    sequence: str
    description: str
    id: int

    @property
    def conventional_id(self) -> int:
        return self.id + 1

    def striped_id(self) -> str:
        desc = self.description.replace("|", " ").replace(".", " ")
        token = desc.split()
        return token[3] if len(token) == 5 else desc


class FastaParseError(RuntimeError):
    pass


def _validate_header(header: str, file_name: str, line: int) -> str:
    delim = header.find(" ")
    if delim == -1:
        out = header[1:]
    else:
        out = header[1:delim]
    if not out:
        raise FastaParseError(
            f"parse error in {file_name} on line {line}: empty header")
    return out


_VALID_DELETE = str.maketrans("", "", "".join(VALID_CHARS))


def _validate_sequence(seq: str, file_name: str, line: int) -> str:
    out = seq.upper()
    # bulk check (translate drops every valid char); the per-char loop
    # runs only on the error path to report the FIRST illegal char in
    # its original (pre-uppercase) spelling, as the reference does
    if out.translate(_VALID_DELETE):
        for orig, ch in zip(seq, out):
            if ch not in VALID_CHARS:
                raise FastaParseError(
                    f"parse error in {file_name} on line {line}: "
                    f"illegal character: {orig}")
    return out


def read_fasta(file_name: str, records: list[FASTARecord] | None = None) -> list[FASTARecord]:
    """Append records from file_name; ids continue from len(records)."""
    if records is None:
        records = []
    seq_id = len(records)
    header = None
    parts: list[str] = []
    line_no = 1
    with open(file_name) as f:
        for raw in f:
            buf = raw.strip()
            if not buf:
                line_no += 1
                continue
            if buf[0] == ">":
                if header is not None:
                    if not parts:
                        raise FastaParseError(
                            f"parse error in {file_name} on line {line_no}: empty sequence")
                    records.append(FASTARecord("".join(parts), header, seq_id))
                    seq_id += 1
                    parts = []
                header = _validate_header(buf, file_name, line_no)
            else:
                parts.append(_validate_sequence(buf, file_name, line_no))
            line_no += 1
    if not parts:
        raise FastaParseError(
            f"parse error in {file_name} on line {line_no}: empty sequence")
    records.append(FASTARecord("".join(parts), header if header is not None else "", seq_id))
    return records


def write_fasta(file_name: str, header: str, sequence: str) -> None:
    """80-column FASTA writer (reference: src/fasta.h:93-107)."""
    with open(file_name, "w") as out:
        out.write(f">{header}\n")
        for i in range(0, len(sequence), 80):
            out.write(sequence[i:i + 80])
            out.write("\n")
