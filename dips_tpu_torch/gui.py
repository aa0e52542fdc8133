"""Desktop GUI: the `entry` frontend's capabilities on Tk.

The reference ships a Slint desktop app (entry/ui/app-window.slint:4-103 +
entry/src/main.rs:15-103): pick an input file, preview a thumbnail, set the
options (colorize, filter, chroma, window size, sensitivity slider), run.
GPU hosts are usually headless, so this is an optional frontend on the
stdlib's Tk — same capabilities, zero extra dependencies; the CLI remains
the primary interface.

Notes kept from the reference: the sensitivity slider is *inverted*
(``SENSITIVITY_MAX - value``, entry/src/main.rs:13,84) — preserved here so
the knob feels the same; thumbnails are cached next to the input file
rather than in a ProjectDirs cache.

Launch: ``python -m dips_tpu_torch.gui`` (requires a display and, unless
``run_gui(device="cpu")``, a card).
"""

from __future__ import annotations

import os
import threading

SENSITIVITY_MAX = 10.0  # ref: entry/src/main.rs:13


def thumbnail_cache_valid(video_path: str, thumb_path: str) -> bool:
    """A cached thumbnail is valid only if it is NEWER than the video —
    re-recording over the same filename must refresh the preview."""
    try:
        return os.path.getmtime(thumb_path) >= os.path.getmtime(video_path)
    except OSError:
        return False


def props_from_controls(colorize: bool, filt: str, chroma: str, method: str,
                        window: int, sensitivity: float):
    """Widget values -> DiPsProperties (factored out of the Tk callbacks so
    the assembly logic is testable headless).

    ``sensitivity`` is the raw slider value; it is inverted the way the
    reference GUI inverts it (SENSITIVITY_MAX - value, entry/src/main.rs:84).
    """
    from .properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             DiPsProperties, OutputMode)
    return DiPsProperties(
        method=DiPsMethod[method.upper()],
        output=(OutputMode.COLORIZE if colorize else OutputMode.GRAYSCALE),
        filter={"sigmoid": DiPsFilter.SIGMOID,
                "inv_sig": DiPsFilter.INVERSE_SIGMOID,
                "none": DiPsFilter.UNFILTERED}[filt],
        chroma={"all": ChromaFilter.ALL, "r": ChromaFilter.RED,
                "g": ChromaFilter.GREEN, "b": ChromaFilter.BLUE}[chroma],
        window_size=int(window),
        # inverted slider, as in the reference GUI
        sensitivity=SENSITIVITY_MAX - float(sensitivity),
    )


def run_gui(device="cuda") -> int:
    from .models.pipeline import resolve_device
    resolve_device(device)  # no card: DeviceError before any window opens
    try:
        import tkinter as tk
        from tkinter import filedialog, messagebox, ttk
    except Exception as e:  # pragma: no cover
        print(f"tkinter unavailable: {e}")
        return 1

    from .app import DiPsJob, perform_dips
    from .io.thumbnail import extract_thumbnail

    try:
        root = tk.Tk()
    except tk.TclError as e:
        print(f"no display available for the GUI ({e}); "
              f"use the CLI: python -m dips_tpu_torch.cli --help")
        return 1
    root.title("DiPs")

    state = {"input": None}

    # --- options panel (parity with app-window.slint options) ------------
    colorize = tk.BooleanVar(value=True)
    filt = tk.StringVar(value="sigmoid")
    chroma = tk.StringVar(value="all")
    method = tk.StringVar(value="overall")
    win = tk.IntVar(value=3)
    sens = tk.DoubleVar(value=5.0)

    frm = ttk.Frame(root, padding=8)
    frm.grid(sticky="nsew")

    thumb_label = ttk.Label(frm, text="(no input chosen)")
    thumb_label.grid(row=0, column=0, columnspan=2, pady=4)
    status = ttk.Label(frm, text="")
    status.grid(row=8, column=0, columnspan=2)

    def pick_input():
        p = filedialog.askopenfilename(title="Choose a video")
        if not p:
            return
        state["input"] = p
        # thumbnail preview, cached beside the input
        tpath = p + ".thumb.png"
        try:
            if not thumbnail_cache_valid(p, tpath):
                extract_thumbnail(p, tpath, height=120)
            img = tk.PhotoImage(file=tpath)
            thumb_label.configure(image=img, text="")
            thumb_label.image = img
        except Exception as e:
            thumb_label.configure(text=f"{os.path.basename(p)} ({e})")

    def run():
        if not state["input"]:
            messagebox.showerror("DiPs", "Choose an input video first")
            return
        if state.get("running"):
            messagebox.showinfo("DiPs", "A run is already in progress")
            return
        out = filedialog.asksaveasfilename(
            title="Output video", defaultextension=".avi")
        if not out:
            return
        props = props_from_controls(colorize.get(), filt.get(), chroma.get(),
                                    method.get(), win.get(), sens.get())
        job = DiPsJob(properties=props, video_path=state["input"],
                      output_path=out, device=device)
        state["running"] = True
        status.configure(text="running…")

        def work():  # run off the UI thread (ref: smol::spawn, main.rs:98)
            try:
                stats = perform_dips(job)
                text = f"done: {stats.shape[0]} frames → {out}"
            except Exception as e:
                text = f"failed: {e}"
            state["running"] = False
            # Tk widgets are NOT thread-safe: marshal the update back onto
            # the mainloop thread (root.after is the documented safe entry);
            # the window may have been closed mid-job
            try:
                root.after(0, lambda: status.configure(text=text))
            except RuntimeError:
                pass

        threading.Thread(target=work, daemon=True).start()

    ttk.Button(frm, text="Input…", command=pick_input).grid(row=1, column=0)
    ttk.Button(frm, text="Run DiPs", command=run).grid(row=1, column=1)
    ttk.Checkbutton(frm, text="Colorize", variable=colorize).grid(
        row=2, column=0, sticky="w")
    for r, (label, var, vals) in enumerate([
            ("Filter", filt, ["sigmoid", "inv_sig", "none"]),
            ("Chroma", chroma, ["all", "r", "g", "b"]),
            ("Method", method, ["overall", "per_frame"])], start=3):
        ttk.Label(frm, text=label).grid(row=r, column=0, sticky="w")
        ttk.OptionMenu(frm, var, var.get(), *vals).grid(
            row=r, column=1, sticky="ew")
    ttk.Label(frm, text="Window").grid(row=6, column=0, sticky="w")
    ttk.Scale(frm, from_=1, to=7, variable=win).grid(
        row=6, column=1, sticky="ew")
    ttk.Label(frm, text="Sensitivity").grid(row=7, column=0, sticky="w")
    ttk.Scale(frm, from_=0, to=SENSITIVITY_MAX, variable=sens).grid(
        row=7, column=1, sticky="ew")

    root.mainloop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(run_gui())
