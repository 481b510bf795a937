"""Reader and writer for the YAML subset the configuration files use.

Supported: block mappings, block sequences of scalars, flow lists
``[a, b]`` and flow mappings ``{k: v}`` of scalars, plain and quoted
scalars with YAML 1.1 resolution (``null``/``~``, booleans, decimal
ints, floats with a dot, ``.inf``/``.nan``), and ``#`` comments. Anything
else (anchors, tags, block scalars, multi-document streams, complex
keys) raises ``ValueError`` instead of being read differently from a
full YAML parser.
"""

import math
import numbers
import re

_NULL = ('', '~', 'null', 'Null', 'NULL')
_TRUE = ('yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON')
_FALSE = ('no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off', 'OFF')
_INT = re.compile(r'[-+]?(?:0|[1-9][0-9_]*)$')
_OTHER_INT = re.compile(r'[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+'
                        r'|[0-9][0-9_]*(?::[0-5]?[0-9])+)$')
_FLOAT = re.compile(r'[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)'
                    r'(?:[eE][-+][0-9]+)?$')
_INF = re.compile(r'([-+]?)\.(?:inf|Inf|INF)$')
_NAN = re.compile(r'\.(?:nan|NaN|NAN)$')
_UNSUPPORTED_START = tuple('&*!|>%@`?')


def _strip_comment(line):
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"' and (i == 0 or line[i - 1] in ' [{,:'):
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


def _split_top(text, sep):
    """Split ``text`` at ``sep`` outside quotes and brackets."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch in '[{':
            depth += 1
        elif ch in ']}':
            depth -= 1
        elif ch == sep and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    if quote or depth:
        raise ValueError(f'unbalanced quotes or brackets: {text!r}')
    parts.append(text[start:])
    return parts


def _key_split(text):
    """(key, rest) at the first ``:`` followed by a space or the end, or
    None when ``text`` is not a mapping entry."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"' and i == 0:
            quote = ch
        elif ch in '[{' and i == 0:
            return None
        elif ch == ':' and (i + 1 == len(text) or text[i + 1] == ' '):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _scalar(text):
    text = text.strip()
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f'unterminated quote: {text!r}')
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f'unterminated quote: {text!r}')
        body = text[1:-1]
        if re.search(r'\\[^"\\n]', body):
            raise ValueError(f'unsupported escape in {text!r}')
        return (body.replace('\\n', '\n').replace('\\"', '"')
                .replace('\\\\', '\\'))
    if text.startswith(_UNSUPPORTED_START) or text.startswith('- '):
        raise ValueError(f'unsupported YAML construct: {text!r}')
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace('_', ''))
    if _OTHER_INT.match(text):
        raise ValueError(f'unsupported integer form: {text!r}')
    if _FLOAT.match(text):
        return float(text.replace('_', ''))
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == '-' else math.inf
    if _NAN.match(text):
        return math.nan
    return text


def _value(text):
    text = text.strip()
    if text[:1] == '[':
        if text[-1:] != ']':
            raise ValueError(f'unterminated flow list: {text!r}')
        inner = text[1:-1].strip()
        if not inner:
            return []
        return [_value(p) for p in _split_top(inner, ',')]
    if text[:1] == '{':
        if text[-1:] != '}':
            raise ValueError(f'unterminated flow mapping: {text!r}')
        inner = text[1:-1].strip()
        out = {}
        for part in (_split_top(inner, ',') if inner else []):
            kv = _key_split(part.strip())
            if kv is None:
                raise ValueError(f'bad flow mapping entry: {part!r}')
            out[_scalar(kv[0])] = _value(kv[1])
        return out
    return _scalar(text)


def loads(text):
    """Parse a document of the supported subset into dicts, lists and
    scalars (None for an empty document)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if '\t' in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f'line {n}: tab indentation')
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ('---', '...') or line.startswith('%'):
            raise ValueError(f'line {n}: document markers are unsupported')
        lines.append((n, len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None
    pos = [0]

    def block(indent):
        n, ind, content = lines[pos[0]]
        if content == '-' or content.startswith('- '):
            return sequence(ind)
        if _key_split(content) is None:
            if len(lines) != 1:
                raise ValueError(f'line {n}: expected a mapping entry')
            pos[0] += 1
            return _value(content)
        return mapping(ind)

    def nested(parent_indent):
        """The block under an entry with an empty value, or None."""
        if pos[0] < len(lines) and lines[pos[0]][1] > parent_indent:
            return block(lines[pos[0]][1])
        return None

    def mapping(indent):
        out = {}
        while pos[0] < len(lines):
            n, ind, content = lines[pos[0]]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f'line {n}: unexpected indentation')
            kv = _key_split(content)
            if kv is None:
                raise ValueError(f'line {n}: expected a mapping entry')
            key = _scalar(kv[0])
            if key in out:
                raise ValueError(f'line {n}: duplicate key {key!r}')
            pos[0] += 1
            out[key] = _value(kv[1]) if kv[1] else nested(indent)
        return out

    def sequence(indent):
        out = []
        while pos[0] < len(lines):
            n, ind, content = lines[pos[0]]
            if ind < indent:
                break
            if ind > indent or not (content == '-'
                                    or content.startswith('- ')):
                raise ValueError(f'line {n}: expected a sequence item')
            item = content[1:].strip()
            if _key_split(item) is not None:
                raise ValueError(f'line {n}: mappings inside sequences '
                                 'are unsupported')
            pos[0] += 1
            if item:
                out.append(_value(item))
            elif pos[0] < len(lines) and lines[pos[0]][1] > indent:
                raise ValueError(f'line {n}: nested blocks inside '
                                 'sequences are unsupported')
            else:
                out.append(None)
        return out

    doc = block(lines[0][1])
    if pos[0] != len(lines):
        n = lines[pos[0]][0]
        raise ValueError(f'line {n}: unexpected indentation')
    return doc


def _dump_scalar(v):
    if hasattr(v, 'item') and not isinstance(v, (str, bytes)):
        v = v.item()                      # numpy scalars
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, numbers.Integral):
        return str(int(v))
    if isinstance(v, numbers.Real):
        v = float(v)
        if math.isnan(v):
            return '.nan'
        if math.isinf(v):
            return '.inf' if v > 0 else '-.inf'
        s = repr(v)
        if '.' not in s:
            s = s.replace('e', '.0e') if 'e' in s else s + '.0'
        if 'e' in s and s[s.index('e') + 1] not in '+-':
            s = s.replace('e', 'e+')
        return s
    if isinstance(v, str):
        if '\n' in v or '\\' in v:
            return '"' + (v.replace('\\', '\\\\').replace('"', '\\"')
                          .replace('\n', '\\n')) + '"'
        plain = (v and v == v.strip() and not re.search(r'[,\[\]{}#:\'"]', v)
                 and not v.startswith(_UNSUPPORTED_START + ('-',))
                 and isinstance(_scalar(v), str))
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise ValueError(f'cannot write {type(v).__name__} as YAML')


def _dump_flow(v):
    if isinstance(v, (list, tuple)):
        return '[' + ', '.join(_dump_flow(x) for x in v) + ']'
    if isinstance(v, dict):
        if v:
            raise ValueError('nested mappings inside lists are unsupported')
        return '{}'
    return _dump_scalar(v)


def dumps(data):
    """Write a mapping as block YAML; lists are written as flow lists."""
    if not isinstance(data, dict):
        raise ValueError('the document must be a mapping')
    out = []

    def emit(d, indent):
        for k, v in d.items():
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(' ' * indent + key + ':')
                emit(v, indent + 2)
            else:
                out.append(' ' * indent + key + ': ' + _dump_flow(v))

    emit(data, 0)
    return '\n'.join(out) + '\n'
