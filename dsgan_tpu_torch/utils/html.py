"""Result-gallery HTML writer (port of ``dsgan_tpu/utils/html.py``):
plain-string HTML, no dependencies."""

import os


class HTML:
    def __init__(self, web_dir, title, reflesh=0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.reflesh = reflesh
        self.body = []

    def get_image_dir(self):
        return self.img_dir

    def add_header(self, str_):
        self.body.append(f"<h3>{str_}</h3>")

    def add_images(self, ims, txts, links, width=400):
        cells = [
            '<td style="word-wrap:break-word;" halign="center" valign="top">'
            f'<p><a href="images/{link}"><img style="width:{width}px" '
            f'src="images/{im}"></a><br>{txt}</p></td>'
            for im, txt, link in zip(ims, txts, links)
        ]
        self.body.append(
            '<table border="1" style="table-layout:fixed;"><tr>' + "".join(cells) + "</tr></table>")

    def save(self):
        meta = f'<meta http-equiv="refresh" content="{self.reflesh}">' if self.reflesh > 0 else ""
        with open(os.path.join(self.web_dir, "index.html"), "wt") as f:
            f.write(f"<!DOCTYPE html><html><head><title>{self.title}</title>{meta}</head>"
                    f"<body>{''.join(self.body)}</body></html>")
