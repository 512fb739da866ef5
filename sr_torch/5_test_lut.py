"""Single-image / scripted LUT inference (CLI-parity with the fork's
sr/5_test_lut.py single-image API, ref: sr/5_test_lut.py:241-414,624-662),
on the CUDA card unless `--device cpu` is given.

Modes:
    python 5_test_lut.py --image in.png --output out.png -e <lut_folder>
    python 5_test_lut.py -e <lut_folder> --testDir <bench>   # dataset mode
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mulut_tpu_torch.pipelines.evaluate import process_single_image, run_test
from mulut_tpu_torch.utils.options import TestOptions


def main_gui(opt):
    """Interactive file-dialog loop (ref: sr/5_test_lut.py:581-621).

    Requires a display + tkinter; the scripted CLI below covers headless use.
    """
    import tkinter as tk
    from tkinter import filedialog, messagebox

    root = tk.Tk()
    root.withdraw()
    while True:
        image = filedialog.askopenfilename(
            title="Select LR image (cancel to quit)",
            filetypes=[("Images", "*.png *.jpg *.jpeg *.bmp")],
        )
        if not image:
            break
        output = filedialog.asksaveasfilename(
            title="Save SR image as", defaultextension=".png"
        )
        out, _ = process_single_image(
            image, opt.expDir, output or None, stages=opt.stages,
            modes=opt.modes, scale=opt.scale, interval=opt.interval,
            lut_name=opt.lutName, device=opt.device,
        )
        messagebox.showinfo(
            "MuLUT", f"Upscaled {image}\n-> {output}\nshape {out.shape}"
        )


def main():
    # peel off the single-image flags, pass the rest to the option system
    peel = argparse.ArgumentParser(add_help=False)
    peel.add_argument("--image", type=str, default=None)
    peel.add_argument("--output", type=str, default=None)
    peel.add_argument("--gt", type=str, default=None)
    peel.add_argument("--gui", action="store_true")
    extra, rest = peel.parse_known_args()

    opt = TestOptions().parse(rest)
    if extra.gui:
        main_gui(opt)
    elif extra.image:
        out, metrics = process_single_image(
            extra.image, opt.expDir, extra.output,
            stages=opt.stages, modes=opt.modes, scale=opt.scale,
            interval=opt.interval, lut_name=opt.lutName, gt_path=extra.gt,
            device=opt.device,
        )
        print(f"Processed {extra.image} -> {extra.output or '(no file)'} "
              f"shape={out.shape}")
        if metrics:
            print(f"PSNR: {metrics[0]:.2f} SSIM: {metrics[1]:.4f}")
    else:
        datasets = [
            d for d in ["Set5", "Set14", "B100", "Urban100", "Manga109"]
            if os.path.isdir(os.path.join(opt.testDir, d, "HR"))
        ]
        run_test(opt, datasets=datasets or ["Set5"], device=opt.device)


if __name__ == "__main__":
    main()
