"""Session lifecycle (mixin for :class:`~dips_tpu.serve.DiPsServer`):
engine binding/pooling, named-token park/resume with latest-wins
takeover, autosave crash recovery, and the per-geometry coalescer
registry of flexible daemons."""

from __future__ import annotations

import logging
import os
import socket
import tempfile
import time
from typing import Optional

import numpy as np

from .coalesce import StreamCoalescer, _CoalescedSession

log = logging.getLogger("dips_tpu.serve")


class SessionMixin:
    """Engine/session lifecycle methods of ``DiPsServer`` (state lives on
    the server instance; see ``server.py`` for the attribute contract)."""

    def _co_for(self, geometry):
        """The coalescer a new session of ``geometry`` binds to: the
        daemon-wide one on a fixed server, a lazily-created per-geometry
        one on a flexible server.  Construction (an N-slot engine build +
        jit compile) runs OUTSIDE ``_pool_lock`` so concurrent binds,
        releases and metrics scrapes never stall behind it; a
        construction race keeps the first registered instance."""
        if self._coalescer is not None:
            return self._coalescer
        if geometry is None:
            raise ValueError(
                "session has no geometry yet - send a frame or load a "
                "checkpoint first (flexible daemon)")
        with self._pool_lock:
            co = self._coalescers.get(geometry)
        if co is not None:
            return co
        built = StreamCoalescer(self._props, geometry[0], geometry[1],
                                **self._coalesce_cfg)
        with self._pool_lock:
            co = self._coalescers.setdefault(geometry, built)
            evicted = (self._evict_idle_coalescers(keep=geometry)
                       if len(self._coalescers) > self.max_geometries
                       else [])
        if co is not built:
            built.shutdown()  # lost the construction race
        for victim in evicted:
            victim.shutdown()
        return co

    def _evict_idle_coalescers(self, keep) -> list:
        """Drop registered coalescers beyond ``max_geometries`` that have
        no bound slots, no queued work and no parked named sessions
        (geometry churn must not accumulate device state without bound).
        Call under ``_pool_lock``; returns the evicted instances for the
        caller to shut down outside it.  Live geometries are never
        evicted — the registry may exceed the cap while all are busy."""
        evicted = []
        parked = {id(v._co) for v in self._named.values()
                  if isinstance(v, _CoalescedSession)}
        for geom in list(self._coalescers):
            if len(self._coalescers) <= self.max_geometries:
                break
            if geom == keep:
                continue
            co = self._coalescers[geom]
            with co._cv:
                busy = bool(co._bound) or bool(co._pending)
            if busy or id(co) in parked:
                continue
            del self._coalescers[geom]
            evicted.append(co)
        if evicted:
            log.info("evicted %d idle geometry coalescer(s)", len(evicted))
        return evicted
    def _autosave_path(self, token: str) -> str:
        from urllib.parse import quote
        return os.path.join(self.autosave_dir,
                            quote(str(token), safe="") + ".npz")

    def _maybe_autosave(self, eng, n_frames: int = 0,
                        force: bool = False) -> None:
        """Crash-safety checkpoint for a named session.  Runs on the
        session's own thread right after its request completed, so the
        engine state is quiescent — never call under ``_pool_lock``."""
        tok = getattr(eng, "session_token", None)
        if self.autosave_dir is None or tok is None:
            return
        due = getattr(eng, "_autosave_due", 0) + n_frames
        eng._autosave_due = due
        if due < (1 if force else self.autosave_every):
            return  # force still skips when nothing changed since the last
        path = self._autosave_path(tok)
        # unique tmp per write: after a takeover TIMEOUT two threads can
        # briefly autosave the same token, and a fixed tmp name would let
        # their np.savez writes interleave into garbage that os.replace
        # then renames over the last good checkpoint.  The '#' marker
        # cannot collide with a quoted token (quote escapes '#').
        fd, tmp = tempfile.mkstemp(dir=self.autosave_dir, suffix=".npz",
                                   prefix=os.path.basename(path)[:-4]
                                   + ".#tmp#")
        os.close(fd)
        try:
            eng.save(tmp)
            os.replace(tmp, path)
            eng._autosave_due = 0
            self._count("autosaves")
        except Exception:  # a full disk must not kill the stream
            log.exception("autosave failed for session %r", tok)
            try:
                os.remove(tmp)
            except OSError:
                pass
    @staticmethod
    def _peek_geometry(path) -> Optional[tuple]:
        """(height, width) recorded in a checkpoint file, or None.
        Raises whatever ``np.load`` raises on an unreadable file — the
        caller decides whether that surfaces (explicit ``load``) or falls
        back to fresh state (autosave recovery)."""
        with np.load(str(path)) as z:
            if "geometry" in z.files:
                return tuple(int(v) for v in z["geometry"])
        return None

    def _try_autorestore(self, eng, token) -> bool:
        """Load ``token``'s last autosave into a freshly-bound engine (the
        daemon-restart resume path).  A stale/mismatched file logs and
        falls back to fresh state rather than failing the bind."""
        if self.autosave_dir is None:
            return False
        path = self._autosave_path(token)
        if not os.path.exists(path):
            return False
        try:
            eng.load(path)
            eng._autosave_due = 0
            self._count("autorestores")
            log.info("session %r restored from autosave (frame %d)",
                     token, eng.frame_index)
            return True
        except Exception as e:
            log.warning("session %r: autosave restore failed (%s): "
                        "starting fresh", token, e)
            eng._autosave_due = 0  # a recycled counter must not carry over
            eng._motion_det = None
            try:
                eng.reset()
            except Exception:
                log.exception("reset after failed restore")
            return False

    def _takeover_token(self, tok: str, client) -> None:
        """Latest-wins token semantics: if ``tok`` is live on another
        connection (a camera reconnecting before the server noticed the
        old link died), shut the old connection down and wait briefly for
        its session to PARK — binding before the park would hand this
        connection a fresh engine and strand the real streaming state."""
        with self._pool_lock:
            old = self._active.get(tok)
        if old is None or old is client:
            return
        self._count("takeovers")
        log.info("session %r taken over by a new connection", tok)
        try:
            old.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._pool_lock:
                if tok in self._named or self._active.get(tok) in (None,
                                                                   client):
                    return
            time.sleep(0.01)
        log.warning("session %r: previous holder did not park in time",
                    tok)
    def _bind_engine(self, token, geometry=None, roi=None):
        """Engine for a session, bound lazily at its FIRST request (the
        request carries the optional session token).  Named tokens resume
        their parked engine; anonymous sessions reuse a pooled engine —
        reset unless this is a single-session server, where resume is
        unambiguous and historical behaviour.  On a flexible daemon,
        ``geometry`` (from the first frame or checkpoint) sizes a new
        engine; pooling is per geometry.

        ``roi``: per-session analysis region — this session's engine gets
        ``props.with_roi(roi)`` (each fleet camera watches a different
        scene).  Roi'd engines never enter the anonymous pool (a pooled
        engine must carry exactly the daemon's props), and a parked named
        session only resumes under the SAME roi."""
        if roi is not None:
            roi = tuple(int(v) for v in roi)
        if self._coalesce_cfg is not None:
            if roi is not None:
                raise ValueError(
                    "per-session roi is not available on a coalescing "
                    "daemon (one stacked kernel is shared); start the "
                    "daemon with --roi for a fleet-wide region")
            with self._pool_lock:
                if token is not None and token in self._named:
                    sess = self._named.pop(token)
                    sess._co.rebind(sess.slot)
                    sess.session_token = token
                    return sess
            co = self._co_for(geometry)  # may build, outside the lock
            with self._pool_lock:
                try:
                    sess = _CoalescedSession(co, co.bind())
                except RuntimeError:
                    # every slot held by a parked named session: evict
                    # the oldest parked on THIS coalescer
                    victims = [k for k, v in self._named.items()
                               if v._co is co]
                    if not victims:
                        raise
                    old = self._named.pop(victims[0])
                    co.release(old.slot)
                    sess = _CoalescedSession(co, co.bind())
            sess.session_token = token
            if token is not None:  # daemon-restart resume (fresh slot)
                self._try_autorestore(sess, token)
            return sess
        eng = None
        resumed = False
        need_reset = token is not None or self.max_sessions > 1
        with self._pool_lock:
            if token is not None and token in self._named:
                eng = self._named.pop(token)
                if roi is not None and eng.props.roi != roi:
                    # silently swapping the region mid-session would make
                    # the event/stats stream incomparable across the swap
                    self._named[token] = eng  # leave it parked
                    raise ValueError(
                        f"session {token!r} is parked with roi "
                        f"{eng.props.roi}; reset it before binding with "
                        f"roi {roi}")
                need_reset = False  # resuming IS the point of the token
                resumed = True      # parked state is newer than any autosave
            elif self.flexible:
                if geometry is None:
                    raise ValueError(
                        "session has no geometry yet - send a frame or "
                        "load a checkpoint first (flexible daemon)")
                if roi is None:  # roi'd sessions never reuse pooled engines
                    lst = self._pool.get(geometry)
                    if lst:
                        eng = lst.pop()
            elif self._pool and roi is None:
                eng = self._pool.pop()
        if eng is None:
            # construction (a jit compile on a new geometry) runs OUTSIDE
            # the lock so concurrent sessions don't stall behind it
            p = None if roi is None else self._props.with_roi(roi)
            eng = (self._mk_engine(*geometry, p=p) if self.flexible
                   else self._mk_engine(p=p))
        elif need_reset or getattr(eng, "_pooled_from_named", False):
            # _pooled_from_named: an evicted/superseded NAMED session's
            # engine in the anonymous pool still holds that camera's state;
            # the single-session resume exception only covers the daemon's
            # own lone anonymous engine, never another token's.
            eng.reset()  # never hand one client another's state
            eng._autosave_due = 0  # ...nor another's unsaved-frame counter
            eng._motion_det = None  # ...nor another's open event
            eng._flicker = None     # ...nor another's flicker window
        eng._pooled_from_named = False
        eng.session_token = token
        if token is not None and not resumed:
            self._try_autorestore(eng, token)  # daemon-restart resume
        return eng

    def _release_engine(self, eng) -> None:
        token = getattr(eng, "session_token", None)
        if isinstance(eng, _CoalescedSession):
            with self._pool_lock:
                if token is not None:
                    old = self._named.pop(token, None)
                    if old is not None and old is not eng:
                        # duplicate token (camera reconnected while the
                        # old connection was still draining): the
                        # superseded parked session's slot must be
                        # freed, not leaked
                        old._co.release(old.slot)
                    self._named[token] = eng
                    eng._co.release(eng.slot, park=True)
                    while len(self._named) > self.max_named_sessions:
                        old = self._named.pop(next(iter(self._named)))
                        old._co.release(old.slot)  # reset + free
                else:
                    eng._co.release(eng.slot)
            return
        with self._pool_lock:
            if token is not None:
                old = self._named.pop(token, None)
                self._named[token] = eng
                if old is not None and old is not eng:
                    old._pooled_from_named = True
                    self._pool_idle_engine(old)  # superseded duplicate
                while len(self._named) > self.max_named_sessions:
                    victim = self._named.pop(next(iter(self._named)))
                    victim._pooled_from_named = True
                    self._pool_idle_engine(victim)
            else:
                self._pool_idle_engine(eng)

    def _pool_idle_engine(self, eng) -> None:
        """Return an idle engine to the anonymous pool (call under
        ``_pool_lock``).  Flexible daemons cap total pooled engines —
        geometry churn must not accumulate unbounded device state —
        evicting from the deepest per-geometry pool first (dropping the
        reference frees its device buffers)."""
        if eng.props != self._props:
            # a per-session-roi engine: never reusable anonymously (the
            # pool's contract is "exactly the daemon's props"); dropping
            # the reference frees its device buffers
            return
        if not self.flexible:
            self._pool.append(eng)
            return
        # pool keys are INPUT geometry (what a session's frames look
        # like); with daemon-wide downscale that differs from the
        # engine's analysis dims
        self._pool.setdefault((eng.in_height, eng.in_width), []).append(eng)
        total = sum(len(v) for v in self._pool.values())
        dropped = 0
        while total > self.max_pooled_engines:
            geom = max(self._pool, key=lambda g: len(self._pool[g]))
            self._pool[geom].pop(0)
            if not self._pool[geom]:
                del self._pool[geom]
            total -= 1
            dropped += 1
        if dropped:
            log.info("evicted %d idle pooled engine(s)", dropped)
