"""VCF text model + bgzipped writer (htslib vcf.c-equivalent surface).

Covers what the reference pipeline needs (src/samtools-1.3.1/htslib-1.3.1/
vcf.c is the format authority; annotate_rd.py:43-257 carries the reference's
own minimal VCF object model which this mirrors functionally):
- header line accumulation with INFO/FORMAT/ALT declarations
- record parse/format incl. INFO key=val map and per-sample FORMAT fields
- bgzip output (+ tabix via formats.tabix)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .bgzf import BGZFWriter, BGZFReader, is_bgzf


@dataclass
class VCFHeader:
    lines: List[str] = field(default_factory=list)  # '##...' lines
    samples: List[str] = field(default_factory=list)

    @classmethod
    def build(
        cls,
        contigs: List[Tuple[str, int]],
        samples: List[str],
        extra: Optional[List[str]] = None,
        source: str = "speedseq_tpu",
    ) -> "VCFHeader":
        lines = ["##fileformat=VCFv4.2", f"##source={source}"]
        lines += [f"##contig=<ID={n},length={l}>" for n, l in contigs]
        lines += extra or []
        return cls(lines=lines, samples=list(samples))

    def add_info(self, id_, number, type_, desc):
        self.lines.append(
            f'##INFO=<ID={id_},Number={number},Type={type_},Description="{desc}">'
        )

    def add_format(self, id_, number, type_, desc):
        self.lines.append(
            f'##FORMAT=<ID={id_},Number={number},Type={type_},Description="{desc}">'
        )

    def add_filter(self, id_, desc):
        self.lines.append(f'##FILTER=<ID={id_},Description="{desc}">')

    def add_alt(self, id_, desc):
        self.lines.append(f'##ALT=<ID={id_},Description="{desc}">')

    def text(self) -> str:
        cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if self.samples:
            cols += "\tFORMAT\t" + "\t".join(self.samples)
        return "\n".join(self.lines + [cols]) + "\n"


def _fmt_val(v) -> str:
    if isinstance(v, bool):
        return ""
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, (list, tuple)):
        return ",".join(_fmt_val(x) for x in v)
    return str(v)


@dataclass
class VCFRecord:
    chrom: str
    pos: int              # 0-based internally; emitted 1-based
    id: str
    ref: str
    alt: List[str]
    qual: Optional[float]
    filter: str
    info: Dict[str, object] = field(default_factory=dict)  # True = flag
    format: List[str] = field(default_factory=list)
    samples: List[Dict[str, object]] = field(default_factory=list)

    def info_str(self) -> str:
        if not self.info:
            return "."
        parts = []
        for k, v in self.info.items():
            if v is True:
                parts.append(k)
            else:
                parts.append(f"{k}={_fmt_val(v)}")
        return ";".join(parts)

    def to_line(self) -> str:
        qual = "." if self.qual is None else f"{self.qual:g}"
        fields = [
            self.chrom,
            str(self.pos + 1),
            self.id or ".",
            self.ref,
            ",".join(self.alt) if self.alt else ".",
            qual,
            self.filter or ".",
            self.info_str(),
        ]
        if self.format:
            fields.append(":".join(self.format))
            for s in self.samples:
                fields.append(
                    ":".join(_fmt_val(s.get(k, ".")) for k in self.format)
                )
        return "\t".join(fields)

    @classmethod
    def from_line(cls, line: str) -> "VCFRecord":
        f = line.rstrip("\n").split("\t")
        info: Dict[str, object] = {}
        if f[7] != ".":
            for kv in f[7].split(";"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    info[k] = v
                else:
                    info[kv] = True
        fmt = f[8].split(":") if len(f) > 8 else []
        samples = []
        for col in f[9:]:
            vals = col.split(":")
            samples.append({k: (vals[i] if i < len(vals) else ".") for i, k in enumerate(fmt)})
        return cls(
            chrom=f[0],
            pos=int(f[1]) - 1,
            id=f[2],
            ref=f[3],
            alt=[] if f[4] == "." else f[4].split(","),
            qual=None if f[5] == "." else float(f[5]),
            filter=f[6],
            info=info,
            format=fmt,
            samples=samples,
        )


class VCFWriter:
    """Writes plain or bgzipped VCF depending on path suffix."""

    def __init__(self, path: str, header: VCFHeader):
        self.path = path
        if path.endswith(".gz"):
            self._w = BGZFWriter(path)
            self._write = lambda s: self._w.write(s.encode())
        else:
            self._fh = open(path, "w")
            self._w = None
            self._write = self._fh.write
        self._write(header.text())

    def write(self, rec: VCFRecord) -> None:
        self._write(rec.to_line() + "\n")

    def write_line(self, line: str) -> None:
        self._write(line if line.endswith("\n") else line + "\n")

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
        else:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_vcf(path: str) -> Tuple[VCFHeader, List[VCFRecord]]:
    if is_bgzf(path):
        text = BGZFReader(path).read().decode()
    elif path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as fh:
            text = fh.read()
    else:
        with open(path) as fh:
            text = fh.read()
    header = VCFHeader()
    records = []
    for line in text.splitlines():
        if line.startswith("##"):
            header.lines.append(line)
        elif line.startswith("#CHROM"):
            cols = line.split("\t")
            header.samples = cols[9:] if len(cols) > 9 else []
        elif line:
            records.append(VCFRecord.from_line(line))
    return header, records
