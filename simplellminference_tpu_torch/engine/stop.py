"""Character-level stop-string matching over a token stream.

The reference has no stop handling at all — decode runs unconditionally
to ``max_length`` (`source/model/model.cpp:157`). The
engine adds ``stop_token_ids`` (exact-id stops, e.g. EOS) and, here,
OpenAI-style **stop strings**: generation halts the moment the decoded
text contains any of the given strings, and the output text is truncated
*exactly* at the match start — even when the stop string straddles token
boundaries or sits in the middle of a token.

Because a stop string can complete several tokens after it starts, the
matcher also drives **holdback**: tokens whose decoded text could still
be part of a stop-string prefix are withheld from streaming until they
are provably safe. On a match the held tokens are never streamed; the
authoritative truncated text is exposed as :attr:`final_text` and the
not-yet-streamed remainder as :meth:`tail_text`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from simplellminference_tpu_torch.tokenizer.base import StreamingDetokenizer


class StopStringMatcher:
    """Incremental stop-string scanner + streaming holdback for one request.

    push() every accepted token in order; it returns True when a stop
    string completes. release() returns the token ids that are now safe
    to stream (their text cannot be part of any future stop match).
    """

    def __init__(self, tokenizer, stop_strings: Sequence[str]):
        self._stops = [s for s in stop_strings if s]
        self._max_stop = max((len(s) for s in self._stops), default=0)
        self._detok = StreamingDetokenizer(tokenizer)
        self.text = ""            # released (UTF-8-complete) text so far
        self._ids: list[int] = []
        self._tok_ends: list[int] = []   # text length after each token
        self._released = 0        # count of ids already handed to release()
        self.matched_at: Optional[int] = None  # char index of match start
        self.final_text: Optional[str] = None  # text truncated at the match

    def push(self, token_id: int) -> bool:
        """Add one token. Returns True if a stop string just completed."""
        prev_len = len(self.text)
        self.text += self._detok.push(token_id)
        self._ids.append(token_id)
        self._tok_ends.append(len(self.text))
        # A new match must END in the new text; it can start at most
        # max_stop-1 chars before it.
        start = max(0, prev_len - self._max_stop + 1)
        best = None
        for s in self._stops:
            i = self.text.find(s, start)
            if i >= 0 and (best is None or i < best):
                best = i
        if best is not None:
            self.matched_at = best
            self.final_text = self.text[:best]
            return True
        return False

    def _hold_chars(self) -> int:
        """Longest text suffix that is a proper prefix of a stop string."""
        hold = 0
        for s in self._stops:
            # check suffix lengths from min(len(s)-1, len(text)) down
            for k in range(min(len(s) - 1, len(self.text)), hold, -1):
                if self.text.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        return hold

    def release(self, finished: bool) -> list[int]:
        """Token ids now safe to stream (empty once a stop matched)."""
        if self.matched_at is not None:
            # Held tokens at/after the match are swallowed (ids are never
            # advanced past the last genuinely streamed token, so
            # released_chars() stays truthful); the remaining text up to
            # the match is delivered via tail_text().
            return []
        if finished:
            out = self._ids[self._released:]
            self._released = len(self._ids)
            return out
        safe = len(self.text) - self._hold_chars()
        if self._detok.has_pending:
            # The detokenizer is holding back a partial UTF-8 sequence:
            # its completion may BEGIN a stop string (e.g. stop "é" whose
            # first byte arrived mid-token), so every token whose visible
            # end touches the pending region is unsafe — releasing it
            # would stream chars a later match excludes from final_text.
            safe = min(safe, len(self.text) - 1)
        n = self._released
        while n < len(self._ids) and self._tok_ends[n] <= safe:
            n += 1
        out = self._ids[self._released:n]
        self._released = n
        return out

    def released_count(self) -> int:
        """Count of ids handed out by release() — on a match, the ids
        whose decoded text lies entirely within ``final_text``."""
        return self._released

    def released_chars(self) -> int:
        """Chars of self.text covered by tokens returned from release()."""
        if self._released == 0:
            return 0
        return self._tok_ends[self._released - 1]

    def tail_text(self) -> str:
        """Exact remaining text to append at finish (after released ids).

        On a stop match this is the text between the last released token
        and the match start; otherwise empty (all ids were released).
        """
        end = self.matched_at if self.matched_at is not None else len(self.text)
        return self.text[self.released_chars():end]
